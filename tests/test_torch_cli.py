"""The port's CLI (``python -m optimization_tpu_torch solve graph.g2o``)
== the JAX package's on the same file.

``cli.main([... "--device", "cpu"])`` against JAX's ``cli.main`` on one
g2o file (``tests/test_cli.py``'s 20-pose graph): the same JSON keys, the
same status, certificate decision and exit code, and the written poses
within 1e-6 of JAX's up to gauge (``alignment_errors``; LOBPCG starts from
another random block in each package, so the robust and the
one-iteration runs start both from one spectral initialization); the
robust route
rejects the same number of edges, both packages' ``solve_robust_se`` run
at three GNC stages of the default six (as ``test_torch_pose_sync.py``
runs it; the CLI passes the stage count through untouched, and the
shorter run bounds the JAX compile time).  The f32 marginalized run (the loose
certificate operator) is held to 1e-3 and the same decision.  Its stop,
and that of the robust route's last GNC stage, may differ: both end at
the objective's noise floor on GRADIENT or TRUST_REGION (exit 0).  Timing keys (``load_s``, ``solve_s``) and the loader's
name are compared as keys only.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import cli as jcli
from optimization_tpu.models import pose_sync as jps
from optimization_tpu_torch import cli
from optimization_tpu_torch.models import pose_sync as ps

import test_cli as jtests
from test_torch_pose_sync import same_spectral_start

torch.set_num_threads(1)

RUNS = {
    "certify": ["--certify", "--dtype", "f64"],
    "marginalized_f32": ["--marginalized", "--certify"],
    "robust": ["--robust", "--dtype", "f64"],
    "iteration_limit": ["--max-iterations", "1", "--dtype", "f64"],
}


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    path, R_true, t_true = jtests._write_graph(
        tmp_path_factory.mktemp("cli"), seed=2)
    return path, R_true, t_true


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_matches_jax(graph_file, tmp_path, capsys, monkeypatch, run):
    path, R_true, t_true = graph_file
    f32 = "f64" not in RUNS[run]
    if run in ("robust", "iteration_limit"):
        # both packages from one spectral start: the GNC scales and a
        # one-iteration stop depend on the start itself
        same_spectral_start(monkeypatch)
    if run == "robust":
        for mod in (jps, ps):
            monkeypatch.setattr(mod, "solve_robust_se", functools.partial(
                mod.solve_robust_se, gnc_steps=3))
    outs = {pkg: str(tmp_path / f"{pkg}.npz") for pkg in ("jax", "port")}
    jrc, jsum = _run(jcli.main, ["solve", path, *RUNS[run], "--json",
                                 "--out", outs["jax"]], capsys)
    rc, summary = _run(cli.main, ["solve", path, *RUNS[run], "--json",
                                  "--out", outs["port"], "--device", "cpu"],
                       capsys)
    assert rc == jrc and set(summary) == set(jsum)
    same = set(jsum) - {"load_s", "solve_s", "loader", "out",
                        "translation_residual", "certificate_lam_min",
                        "certificate_stationarity"}
    if f32 or run == "robust":
        # f32 TNT, and the last GNC stage (started at the previous stage's
        # optimum), end at the objective's noise floor on GRADIENT or
        # TRUST_REGION after a few iterations, by round-off (both exit 0)
        same -= {"status", "tnt_iterations"}
        assert summary["status"] in ("GRADIENT", "TRUST_REGION")
    assert {k: summary[k] for k in same} == {k: jsum[k] for k in same}
    assert summary["out"] == outs["port"]
    ours, theirs = np.load(outs["port"]), np.load(outs["jax"])
    er, et = ps.alignment_errors(torch.from_numpy(ours["R"]).double(),
                                 ours["t"], theirs["R"], theirs["t"])
    tol = 1e-3 if f32 else 1e-6
    if run != "iteration_limit":
        assert float(er) < tol and float(et) < tol, (float(er), float(et))
        er, et = ps.alignment_errors(torch.from_numpy(ours["R"]).double(),
                                     ours["t"], R_true, t_true)
        assert float(er) < 0.05 and float(et) < 0.2
    if run == "iteration_limit":
        assert rc == 2 and summary["status"] == "ITERATION_LIMIT"
    else:
        assert rc == 0
    if "translation_residual" in jsum:
        np.testing.assert_allclose(summary["translation_residual"],
                                   jsum["translation_residual"],
                                   rtol=tol, atol=tol)


def test_cli_writes_g2o_vertices(graph_file, tmp_path, capsys):
    path, _, _ = graph_file
    out = str(tmp_path / "sol.g2o")
    rc = cli.main(["solve", path, "--staircase", "--dtype", "f64", "--out",
                   out, "--device", "cpu"])
    assert rc == 0
    text = open(out).read()
    assert text.count("VERTEX_SE3:QUAT") == 20 and "EDGE_SE3:QUAT" in text
    prose = capsys.readouterr().out
    assert "status: GRADIENT" in prose and "loader: native" in prose


def test_cli_has_no_cpu_fallback(graph_file, monkeypatch):
    path, _, _ = graph_file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["solve", path, "--json"])


def test_cli_help_names_the_port():
    parser = cli._build_parser()
    assert parser.prog == "python -m optimization_tpu_torch"
    text = parser._subparsers._group_actions[0].choices["solve"].format_help()
    assert "--device" in text and "TPU" not in text
