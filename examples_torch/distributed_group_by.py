"""Distributed group-by over a shard mesh (counterpart of
examples/distributed_group_by.py: hash shuffle by all_to_all, local
grouped aggregation, disjoint groups per shard).  The 8 shards are
threads of this process on one device (arrow_tpu_torch/parallel/mesh.py,
`LocalMesh`), as the reference's example uses 8 virtual CPU devices.

    python examples_torch/distributed_group_by.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from arrow_tpu_torch import parallel as par

SHARDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    mesh = par.make_mesh(SHARDS, ap.parse_args(argv).device)
    ndev = mesh.size
    n = 8192
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 32, n).astype(np.int64)
    vals = rng.integers(-50, 50, n).astype(np.int64)
    valid = np.ones(n, bool)

    def agg(comm, k, v, ok):
        gk, gv, outs, overflow = par.dist_group_by(
            comm, k, ok, shuffle_cap=2 * n // ndev, group_cap=64,
            specs=[("sum", v)])
        return gk, gv, outs[0], overflow

    dev = mesh.devices[0]
    gk, gv, gsum, overflow = (x.cpu().numpy() for x in par.shard_map(
        agg, mesh, in_specs=(0, 0, 0), out_specs=(0, 0, 0, None))(
        *(torch.from_numpy(a).to(dev) for a in (keys, vals, valid))))
    assert not overflow, "capacity overflow flagged"
    got = {int(k): int(s) for k, v, s in zip(gk, gv, gsum) if v}
    exp = {}
    for k, v in zip(keys, vals):
        exp[int(k)] = exp.get(int(k), 0) + int(v)
    assert got == exp
    print(f"{len(got)} groups aggregated across {ndev} devices; "
          f"spot check key 0 -> {got.get(0)}")


if __name__ == "__main__":
    main()
