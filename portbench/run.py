"""Run one cell of the port's benchmark once, on the card, and print its
result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
found by name under ``portbench/`` (``harness/spec.py``).  The inputs come
from ``--seed``; set-up (imports, the card, the kernels' build or load, a
warm-up at the window's sizes) runs first and ``setup_s`` counts it; then
the cell's traffic runs for ``--seconds``.  With ``--trace 1`` a block of
the window is profiled and the line carries the cell's per-layer metrics
in place of its end-to-end ones.  Once the window has closed the sampled
answers are held against the plain reference; the numbers compared, each
beside its limit, are the last lines on standard error and the last key of
the result, whose ``correct`` is true when every one is within its limit.

Exits 2 without a result when the cell's CUDA devices are not there, 3
when JAX, flax or the JAX package was loaded, and 1 on any other error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there builds (the port itself builds into
# mpc_verde_tpu_torch/_build/)
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path[:0] = [str(HERE), str(ROOT)]

BANNED = ("jax", "jaxlib", "flax", "mpc_verde_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def start(args, control: bool = False):
    """The card's description and the cell's run, after the check for the
    cell's cards (exits 2 without them)."""
    import torch

    from harness import cell as cellmod
    from harness import device as devmod
    from harness import spec

    stamps = [("imports", time.perf_counter())]
    cell = spec.load_cell(args.workload)
    try:
        devmod.require_cards(cell.chips)
    except devmod.NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        sys.exit(2)
    torch.cuda.init()
    stamps.append(("cuda_init", time.perf_counter()))
    card = devmod.card_info()
    stamps.append(("nvidia_smi", time.perf_counter()))
    device = {"platform": "gpu", "kind": card["kind"], "count": cell.chips,
              "nvidia_smi_name": card["smi_name"],
              "power_limit_w": card["power_limit_w"]}
    run = cellmod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START, control=control,
                           stamps=stamps)
    found = banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        sys.exit(3)
    return run, device


def main(argv=None) -> int:
    from harness import cell as cellmod

    args = parse(argv)
    run, device = start(args)
    for k, v in run.readings.items():
        if k not in run.checks:
            print(f"reading {k} = {v!r}", file=sys.stderr)
    print("\n".join(cellmod.check_lines(run.checks)), file=sys.stderr,
          flush=True)
    print(json.dumps(cellmod.result_line(run, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
