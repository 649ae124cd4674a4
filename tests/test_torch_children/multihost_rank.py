"""One process of tests/test_torch_multihost.py: wires up the port's
``parallel.initialize_distributed`` against a coordinator on 127.0.0.1
(gloo) and checks a cross-process reduction on local shards and on a
``DTensor``.

    python tests/test_torch_children/multihost_rank.py <host:port> <world> <rank>

Prints ``OK <rank>`` on success; any mismatch exits non-zero.
"""

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from optimization_tpu_torch.parallel import (collectives,  # noqa: E402
                                             initialize_distributed,
                                             model_mesh)
from optimization_tpu_torch.parallel.sharding import (  # noqa: E402
    shard_model_vector)


def main():
    coord, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    initialize_distributed(coordinator_address=coord, num_processes=world,
                           process_id=rank, device_type="cpu",
                           timeout=datetime.timedelta(seconds=120))
    # a second call is a no-op, as JAX's is
    initialize_distributed(coordinator_address=coord, num_processes=world,
                           process_id=rank, device_type="cpu")
    mesh = model_mesh(devices="cpu")
    assert mesh.size() == world
    n = 8 * world
    u = torch.arange(n, dtype=torch.float64)
    local = u[rank * 8:(rank + 1) * 8]
    got = float(collectives.pdot(local, torch.ones(8, dtype=torch.float64),
                                 mesh))
    assert got == float(u.sum()), got
    total = float(torch.sum(shard_model_vector(u, mesh)).full_tensor())
    assert total == float(u.sum()), total
    torch.distributed.destroy_process_group()
    print("OK", rank, flush=True)


if __name__ == "__main__":
    main()
