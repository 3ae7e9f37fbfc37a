"""The port's benchmark: one cell, one run, one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json and the port's
package `spatially_aware_ai_tpu_torch`. The cell names its configuration
(`perfbench/configs/<config>.json`) and its traffic mix
(`perfbench/traffic/<traffic>.json`); the mix names the runner that runs it
(`perfbench/harness/<runner>.py`). With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, each read by
`perfbench/metrics/<metric>.py`. See perfbench/README.md.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Fixed cache and build directories inside the checkout, and none of
    the port's behaviour switches from the caller's environment."""
    for key in [k for k in os.environ if k.startswith("SAI_")]:
        del os.environ[key]
    build = os.path.join(ROOT, "build")
    os.environ["SAI_TORCH_BUILD_DIR"] = os.path.join(build,
                                                     "sai_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "perfbench",
                                                  "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "perfbench",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


if __name__ == "__main__":
    _environment()
    sys.path.insert(0, ROOT)
    from perfbench.harness.cli import main

    sys.exit(main(sys.argv[1:], ROOT))
