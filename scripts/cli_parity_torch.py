#!/usr/bin/env python3
"""CLI parity of vapor_tpu_torch on the card: every golden of
fixtures/golden/ re-run through the port's CLI on the device, diffed
byte for byte against the committed golden.

The goldens cover bed (DEL, INV, tandem DUP, and the junction mode of
events over 10 kb), vcf of every SV type (the TSV, and the annotated VCF
that vcf mode writes over <sv-input>.vapor), the vcf fallback branches,
svelter and the MELT ins mode.  Their cases are built by
vapor_tpu_torch/sim/goldens.py.  Each backend runs in a process of its
own:

  torch           cross-event batching and the device window refiner
                  (the default)
  torch-nobatch   one launch per request

Prints pass/FAIL and seconds per golden and backend, each golden's
kernel launches, and the card's name and power limit; writes the result
as JSON to --out.  Exits non-zero when a golden differs or a backend's
process fails.

    python3 scripts/cli_parity_torch.py [backend ...] [--device cuda|cpu]
        [--out chiprun_out/cli_parity_torch.json]
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BACKENDS = ("torch", "torch-nobatch")
RESULT = "BACKENDRESULT "


def run_backend(backend, device, names=None):
    """Every golden (or the named ones) through `backend` on `device`, in
    this process; returns {name: {"ok", "s", "launches", ...}}."""
    from vapor_tpu_torch.sim.goldens import check_goldens
    return check_goldens(backend, device, names,
                         log=lambda line: print(line, flush=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("backends", nargs="*", default=list(BACKENDS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "cli_parity_torch.json"))
    ap.add_argument("--child", action="store_true",
                    help="run the goldens of one backend in this process")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("cli_parity_torch: no CUDA card (--device cpu runs on the "
              "CPU)", file=sys.stderr)
        return 1
    from vapor_tpu_torch.engine.kernels.roofline import card_line
    if args.child:
        (backend,) = args.backends
        print(RESULT + json.dumps(run_backend(backend, args.device)),
              flush=True)
        return 0

    routes, n_fail = {}, 0
    for backend in args.backends:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--device", args.device, backend],
            capture_output=True, text=True)
        payload = None
        for line in p.stdout.splitlines():
            if line.startswith(RESULT):
                payload = json.loads(line[len(RESULT):])
            else:
                print(f"[{backend}] {line}", flush=True)
        if p.returncode != 0 or payload is None:
            routes[backend] = {"error": (p.stderr or p.stdout)[-3000:]}
            print(f"[{backend}] process exited {p.returncode}:\n"
                  f"{routes[backend]['error']}", flush=True)
            n_fail += 1
            continue
        routes[backend] = payload
        n_fail += sum(not r["ok"] for r in payload.values())
    report = {
        "what": "the CLI outputs of every golden recomputed through the "
                "port on the device, byte-diffed against fixtures/golden; "
                "one process per backend",
        "device": args.device,
        "card": card_line() if args.device == "cuda" else None,
        "routes": routes,
        "all_pass": n_fail == 0,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps({"device": args.device, "card": report["card"],
                      "all_pass": report["all_pass"]}))
    print(f"wrote {args.out}: "
          f"{'ALL PASS' if n_fail == 0 else f'{n_fail} FAILURES'}",
          flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
