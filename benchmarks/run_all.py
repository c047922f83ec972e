"""Run every BASELINE.json benchmark config on one GPU and print one JSON
object each, tagged with the device and the card's power limit.

Usage: python -m benchmarks.run_all [--only NAME]

Exits non-zero when JAX finds no GPU or when any config fails.
"""

import argparse
import json
import sys
import traceback


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"run_all: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2

    from benchmarks.configs import ALL
    from fft_convolution_tpu.utils.compile_cache import enable_compile_cache
    from fft_convolution_tpu.utils.profiling import gpu_cards

    enable_compile_cache()
    tag = {"device": {"platform": devices[0].platform,
                      "kind": devices[0].device_kind, "count": len(devices)},
           "card": gpu_cards()}
    failed = []
    for name, fn in ALL.items():
        if args.only and args.only != name:
            continue
        try:
            metrics = fn()
        except Exception as e:  # noqa: BLE001 - report, run the rest, fail
            traceback.print_exc(file=sys.stderr)
            print(json.dumps({"config": name,
                              "error": f"{type(e).__name__}: {e}", **tag}),
                  flush=True)
            failed.append(name)
            continue
        print(json.dumps({"config": name, **{
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in metrics.items()
        }, **tag}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
