"""What a captured NCCL collective costs the eager collectives that share
its communicator, and the two forms of the sharded all_gather, on this card.

    python -m relp_tpu_torch.tools.mesh_mixing [--reps N] [--parent DIR]

It starts one child process for each setting of NCCL_GRAPH_MIXING_SUPPORT
(left unset, NCCL's default, which allows captured and eager NCCL calls to
overlap; and ``0``).  Each child starts an NCCL world of one
(``parallel.initialize_multihost``), takes chip_smoke's chunk-loop problem
(``testing.synthetic_start(m=1024, n=4096, pad=128, seed=7)``, f32, phase-1
costs, steepest edge), cut to the (1, 1) mesh's column block, and times in
two windows, paths interleaved, ms a pivot as the median of the (300 - 10)-
pivot differences:

* ``sharded``: the eager sharded chunk, its all_gather into one tensor
  (``parallel.sharded.all_gather``);
* ``sharded_list``: the same chunk with the all_gather into a list of
  outputs, then stacked (the form the sharded chunk had before its capture);
* ``unsharded``: the eager chunk without a shard (no collective);
* each collective alone, 200 calls at the chunk's sizes.

The first window runs before anything is captured; then the sharded chunk
is captured (``simplex.graphs.ChunkGraphs.run_chunk(..., shard=)``) and
replayed, and the second window runs after it, with the replayed chunk's
ms a pivot beside.  With ``--parent DIR`` (another checkout of the
repository, such as the commit before the captured sharded loops) it then
runs the first window alone, without ``sharded_list``, in four more
children, NCCL's settings left as they are, with the package of DIR, of
this checkout, of this checkout and of DIR in turn (``sharded`` is then
that tree's own all_gather).  Each
child prints one JSON line; the parent process prints the card's name and
power limit first.  Needs a card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

SETTINGS = (None, "0")
ROOT = pathlib.Path(__file__).resolve().parents[2]


def _child(reps: int, capture: bool) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from relp_tpu_torch.parallel import (
        column_shard,
        initialize_multihost,
        make_mesh,
        shard_state,
        sharded,
        sharded_run_chunk,
    )
    from relp_tpu_torch.simplex import graphs, kernels
    from relp_tpu_torch.testing import synthetic_start

    device = torch.device("cuda")
    state0, A, c, _c2, cand = synthetic_start(m=1024, n=4096, pad=128, seed=7,
                                              dtype=np.float32, device=device)
    kw = dict(pricing=kernels.PRICE_STEEPEST, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7)
    tensor_form = sharded.all_gather

    def list_form(t, group, size):
        sharded.COLLECTIVES += 1
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.stack(parts)

    initialize_multihost()
    try:
        mesh = make_mesh((1, 1))
        shard = column_shard(mesh, A.shape[1], device)
        A_s, c_s, cand_s = shard.take(A), shard.take(c), shard.take(cand)
        state_s = shard_state(mesh, state0, A.shape[1])
        captured = graphs.ChunkGraphs()

        def timed(fn, gather=tensor_form):
            def run(chunk):
                sharded.all_gather = gather
                try:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    pivots = int(fn(chunk).iteration)  # the sync inside the region
                    return time.perf_counter() - t, pivots
                finally:
                    sharded.all_gather = tensor_form
            return run

        eager = lambda ch: sharded_run_chunk(shard, state_s, A_s, A_s, c_s, cand_s,
                                             chunk=ch, **kw)
        runs = {
            "sharded": timed(eager),
            "unsharded": timed(lambda ch: kernels.run_chunk(state0, A, A, c, cand,
                                                            chunk=ch, **kw)),
        }
        if capture:  # this tree's callers take the one (size, ...) tensor
            runs["sharded_list"] = timed(eager, list_form)
        graph_run = timed(lambda ch: captured.run_chunk(state_s, A_s, A_s, c_s, cand_s,
                                                        chunk=ch, shard=shard, **kw))
        pick = torch.zeros(3, dtype=torch.float64, device=device)
        column = torch.zeros(2 * A.shape[0] + 1, dtype=A.dtype, device=device)
        collectives = {
            "all_gather": lambda: tensor_form(pick, shard.group, 1),
            "all_gather_list": lambda: list_form(pick, shard.group, 1),
            "all_reduce": lambda: sharded.all_reduce(column, shard.group),
        }

        def window(paths):
            for run in paths.values():
                for chunk in (10, 300):
                    run(chunk)
            per_pivot = {path: [] for path in paths}
            for rep in range(reps):
                for path in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
                    t_small, i_small = paths[path](10)
                    t_big, i_big = paths[path](300)
                    per_pivot[path].append((t_big - t_small) / (i_big - i_small) * 1e3)
            found = {f"{path}_ms_per_pivot": float(np.median(v))
                     for path, v in per_pivot.items()}
            for name, call in collectives.items():
                call()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(200):
                    call()
                torch.cuda.synchronize()
                found[f"{name}_ms"] = (time.perf_counter() - t) / 200 * 1e3
            return found

        before = window(runs)
        if not capture:
            return {"tree": str(pathlib.Path(sharded.__file__).resolve().parents[2]),
                    "reps": reps, "before_capture": before}
        # Capture the sharded chunk (the first call of each chunk length
        # captures it) and check a replay against the eager chunk.
        graph_state = captured.run_chunk(state_s, A_s, A_s, c_s, cand_s, chunk=60,
                                         shard=shard, **kw)
        eager_state = eager(60)
        same = all(g.dtype == e.dtype and torch.equal(g.reshape(-1).view(torch.uint8),
                                                      e.reshape(-1).view(torch.uint8))
                   for g, e in zip(graph_state, eager_state))
        after = window(dict(runs, graph=graph_run))
        return {"nccl_graph_mixing_support": os.environ.get("NCCL_GRAPH_MIXING_SUPPORT",
                                                            "unset (1)"),
                "reps": reps, "graph_bitwise_eager": same, "captures": graphs.CAPTURES,
                "before_capture": before, "after_capture": after}
    finally:
        # What releases the steps' caches and destroys the groups, where
        # the tree has it; nothing here fills those caches.
        from relp_tpu_torch import parallel

        getattr(parallel, "shutdown_multihost", dist.destroy_process_group)()


def _run(tree: pathlib.Path, reps: int, capture: bool, setting=None) -> bool:
    """One child with ``tree``'s package; prints its line, or its error."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("NCCL_GRAPH_MIXING_SUPPORT", "MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(tree)
    if setting is not None:
        env["NCCL_GRAPH_MIXING_SUPPORT"] = setting
    done = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--child",
                           str(reps), "capture" if capture else "eager"],
                          env=env, cwd=str(tree), capture_output=True, text=True)
    lines = done.stdout.strip().splitlines()
    if done.returncode != 0 or not lines:
        print(f"{tree} NCCL_GRAPH_MIXING_SUPPORT={setting}: exit {done.returncode}\n"
              f"{done.stderr[-3000:]}", flush=True)
        return False
    print(lines[-1], flush=True)
    return True


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--child"]:
        print(json.dumps(_child(int(args[1]), args[2] == "capture")), flush=True)
        return 0
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 6
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    ok = [_run(ROOT, reps, True, setting) for setting in SETTINGS]
    if "--parent" in args:
        parent = pathlib.Path(args[args.index("--parent") + 1]).resolve()
        ok += [_run(tree, reps, False) for tree in (parent, ROOT, ROOT, parent)]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
