"""Whether the batch driver's batched refactorization can be captured in a
CUDA graph on this card, at the batch shapes the port meets.

    python -m relp_tpu_torch.tools.inverse_capture [B:M:DTYPE ...]

For each (B, M, dtype), in a process of its own (a refused capture can
leave the CUDA context unusable), it builds B well-conditioned (M, M)
bases, runs the batched refactorization that ``parallel.batch._v_refactor``
runs (``torch.vmap`` of ``simplex.kernels.refactorize_from``: torch's
``linalg.inv_ex`` in f32, then Newton-Schulz in the dtype) once eagerly on
a side stream, then captures it and replays the graph, and prints one line:
``captured`` with whether the replay gives the eager bits, or ``refused``
with the error.  The default shapes are the scenario families' (256 x 128,
128 x 512, f32), mip/real's node waves (64 x 128, f32) and mip/real64's
(16 x 128 and 16 x 256, f64), and three narrow batches.  torch's default
linear-algebra backend decides the route (cuSOLVER or MAGMA) by the shape,
and ``torch.backends.cuda.preferred_linalg_library()`` is printed first.
Needs a card.
"""

from __future__ import annotations

import subprocess
import sys

SHAPES = ("256:128:float32", "128:512:float32", "64:128:float32", "16:128:float64",
          "16:256:float64", "16:128:float32", "8:32:float64", "2:128:float64",
          "1:128:float64")


def _one(B: int, M: int, dtype_name: str) -> str:
    import functools

    import torch

    from relp_tpu_torch.simplex.kernels import refactorize_from

    dtype = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(B * M)
    eye = torch.eye(M, dtype=torch.float64)
    Bm = (torch.randn(B, M, M, generator=g, dtype=torch.float64) + M * eye).to(dtype).cuda()
    cB = torch.randn(B, M, generator=g, dtype=torch.float64).to(dtype).cuda()
    b = torch.randn(B, M, generator=g, dtype=torch.float64).to(dtype).cuda()
    body = functools.partial(torch.vmap(functools.partial(refactorize_from,
                                                          newton_steps=1)), Bm, cB, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            got = body()
        graph.replay()
        torch.cuda.synchronize()
    except Exception as err:  # the capture's own error, reported
        return f"refused {type(err).__name__}: {str(err).splitlines()[0][:160]}"
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    return f"captured replay_bitwise={same}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        B, M, dtype = argv[1].split(":")
        print(_one(int(B), int(M), dtype), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("inverse_capture: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} magma={torch.cuda.has_magma} "
          f"preferred={torch.backends.cuda.preferred_linalg_library()}", flush=True)
    for shape in argv or SHAPES:
        run = subprocess.run(
            [sys.executable, "-m", "relp_tpu_torch.tools.inverse_capture", "--one", shape],
            capture_output=True, text=True, timeout=300)
        out = run.stdout.strip().splitlines() or [f"failed rc={run.returncode}: "
                                                  + run.stderr.strip()[-200:]]
        print(f"[inverse_capture] B:M:dtype={shape} {out[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
