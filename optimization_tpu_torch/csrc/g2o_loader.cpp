// Native pose-graph data loader for the rotation-synchronization model.
//
// Parses g2o-format pose-graph files (the input format of the SE-Sync
// problem family that the reference solver suite serves) into flat edge
// arrays consumable by optimization_tpu.models.rotation_sync:
//
//   VERTEX_SE2 id x y theta
//   EDGE_SE2 i j dx dy dtheta I11 I12 I13 I22 I23 I33
//   VERTEX_SE3:QUAT id x y z qx qy qz qw
//   EDGE_SE3:QUAT i j dx dy dz qx qy qz qw I11 .. I66 (21 upper-tri entries)
//
// Exposed as a C ABI (driven from Python via ctypes — see
// optimization_tpu/io/g2o.py).  Two-pass API: g2o_count() sizes the buffers,
// g2o_load() fills caller-allocated arrays.  Rotations are returned as
// row-major d x d matrices; the translation and the rotation-block
// information weight (kappa) ride along for downstream SE-Sync-style use.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Edge {
  int32_t i, j;
  double R[9];   // row-major, top-left d x d block used
  double t[3];
  double kappa;  // rotational information weight
};

struct Graph {
  int dim = 0;  // 2 or 3
  int n_vertices = 0;
  std::vector<Edge> edges;
  bool ok = false;
  std::string error;
};

void rot2_from_theta(double theta, double* R) {
  const double c = std::cos(theta), s = std::sin(theta);
  R[0] = c; R[1] = -s; R[2] = 0;
  R[3] = s; R[4] = c;  R[5] = 0;
  R[6] = 0; R[7] = 0;  R[8] = 1;
}

void rot3_from_quat(double qx, double qy, double qz, double qw, double* R) {
  // Normalize defensively; files in the wild carry rounded quaternions.
  const double n = std::sqrt(qx * qx + qy * qy + qz * qz + qw * qw);
  if (n > 0) { qx /= n; qy /= n; qz /= n; qw /= n; }
  R[0] = 1 - 2 * (qy * qy + qz * qz);
  R[1] = 2 * (qx * qy - qz * qw);
  R[2] = 2 * (qx * qz + qy * qw);
  R[3] = 2 * (qx * qy + qz * qw);
  R[4] = 1 - 2 * (qx * qx + qz * qz);
  R[5] = 2 * (qy * qz - qx * qw);
  R[6] = 2 * (qx * qz - qy * qw);
  R[7] = 2 * (qy * qz + qx * qw);
  R[8] = 1 - 2 * (qx * qx + qy * qy);
}

Graph parse(const char* path) {
  Graph g;
  std::ifstream in(path);
  if (!in) {
    g.error = "cannot open file";
    return g;
  }
  int max_vertex = -1;
  std::string line, tag;
  while (std::getline(in, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    tag.clear();  // a failed extraction must not reuse the previous tag
    ss >> tag;
    if (tag.empty()) continue;  // whitespace-only / CRLF-blank lines
    if (tag == "VERTEX_SE2" || tag == "VERTEX_SE3:QUAT") {
      int id = -1;
      ss >> id;
      if (!ss || id < 0) {
        g.error = "malformed or negative vertex id";
        return g;
      }
      if (id > max_vertex) max_vertex = id;
      int d = (tag == "VERTEX_SE2") ? 2 : 3;
      if (g.dim && g.dim != d) { g.error = "mixed SE2/SE3 file"; return g; }
      g.dim = d;
    } else if (tag == "EDGE_SE2") {
      Edge e{};
      double dx, dy, dth, I[6];
      ss >> e.i >> e.j >> dx >> dy >> dth;
      for (double& v : I) ss >> v;
      if (!ss) { g.error = "malformed EDGE_SE2 line"; return g; }
      if (e.i < 0 || e.j < 0) {
        // A negative index would silently wrap downstream gathers.
        g.error = "negative vertex index";
        return g;
      }
      rot2_from_theta(dth, e.R);
      e.t[0] = dx; e.t[1] = dy; e.t[2] = 0;
      e.kappa = I[5];  // I33: the rotational block of the SE2 information
      if (g.dim && g.dim != 2) { g.error = "mixed SE2/SE3 file"; return g; }
      g.dim = 2;
      if (e.i > max_vertex) max_vertex = e.i;
      if (e.j > max_vertex) max_vertex = e.j;
      g.edges.push_back(e);
    } else if (tag == "EDGE_SE3:QUAT") {
      Edge e{};
      double dx, dy, dz, qx, qy, qz, qw, I[21];
      ss >> e.i >> e.j >> dx >> dy >> dz >> qx >> qy >> qz >> qw;
      for (double& v : I) ss >> v;
      if (!ss) { g.error = "malformed EDGE_SE3:QUAT line"; return g; }
      if (e.i < 0 || e.j < 0) {
        g.error = "negative vertex index";
        return g;
      }
      rot3_from_quat(qx, qy, qz, qw, e.R);
      e.t[0] = dx; e.t[1] = dy; e.t[2] = dz;
      // Rotational information: mean diagonal of the rotation block
      // (entries I44, I55, I66 of the upper-triangular listing:
      //  offsets 15, 18, 20).
      e.kappa = (I[15] + I[18] + I[20]) / 3.0;
      if (g.dim && g.dim != 3) { g.error = "mixed SE2/SE3 file"; return g; }
      g.dim = 3;
      if (e.i > max_vertex) max_vertex = e.i;
      if (e.j > max_vertex) max_vertex = e.j;
      g.edges.push_back(e);
    }
    // Unknown tags (landmarks etc.) are skipped.
  }
  g.n_vertices = max_vertex + 1;
  g.ok = !g.edges.empty();
  if (!g.ok && g.error.empty()) g.error = "no pose-graph edges found";
  return g;
}

std::string g_last_error;

}  // namespace

extern "C" {

// Returns 0 on success.  Sizes: *n_vertices, *n_edges, *dim (2 or 3).
int g2o_count(const char* path, int32_t* n_vertices, int32_t* n_edges,
              int32_t* dim) {
  Graph g = parse(path);
  if (!g.ok) { g_last_error = g.error; return 1; }
  *n_vertices = g.n_vertices;
  *n_edges = static_cast<int32_t>(g.edges.size());
  *dim = g.dim;
  return 0;
}

// Fills caller-allocated arrays:
//   src, dst: int32[n_edges]
//   Rij:      double[n_edges * 9]  (row-major 3x3; SE2 embeds in top-left 2x2)
//   tij:      double[n_edges * 3]
//   kappa:    double[n_edges]
int g2o_load(const char* path, int32_t* src, int32_t* dst, double* Rij,
             double* tij, double* kappa) {
  Graph g = parse(path);
  if (!g.ok) { g_last_error = g.error; return 1; }
  for (size_t e = 0; e < g.edges.size(); ++e) {
    const Edge& ed = g.edges[e];
    src[e] = ed.i;
    dst[e] = ed.j;
    std::memcpy(Rij + 9 * e, ed.R, 9 * sizeof(double));
    std::memcpy(tij + 3 * e, ed.t, 3 * sizeof(double));
    kappa[e] = ed.kappa;
  }
  return 0;
}

const char* g2o_last_error() { return g_last_error.c_str(); }

}  // extern "C"
