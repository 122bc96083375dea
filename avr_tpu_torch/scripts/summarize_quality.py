"""Consolidate a quality workdir into markdown tables (port of
``scripts/summarize_quality.py``).

The test table of every ``eval_*.json`` (``quality_ab``'s): PSNR / SSIM /
lpips_rand for the final and best checkpoints, raw and EMA, the band
sweep, and the port's ms a step and skipped updates.  With ``--against
ARM=LOG``, the arm's val curve (``logs/{ARM}.jsonl``) beside the val lines
of a JAX run's log (``[val] ... step=S psnr=P ssim=Q``) at the same steps.

    python -m avr_tpu_torch.scripts.summarize_quality --workdir runs/q \\
        --against VR_dd10k=logs/r5_queue/VR_dd10k.log
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

__all__ = ["main", "test_table", "val_table"]


def _cell(m):
    if not m:
        return "—"
    s = f"{m['psnr']:.2f} / {m['ssim']:.3f}"
    return s + (f" / {m['lpips_rand']:.2e}" if "lpips_rand" in m else "")


def test_table(workdir: str):
    rows = ["| Arm | steps | final (raw) | best-val (raw) | final (EMA) | best-val (EMA) | "
            "eps sweep (best ckpt) | ms a step | skipped |",
            "|---|---|---|---|---|---|---|---|---|"]
    for path in sorted(glob.glob(os.path.join(workdir, "eval_*.json"))):
        arm = os.path.basename(path)[5:-5]
        with open(path) as f:
            d = json.load(f)
        eps = "; ".join(f"{k}x: {v['psnr']:.2f}" for k, v in
                        sorted((d.get("eps_sweep") or {}).items(), key=lambda kv: float(kv[0])))
        ms = d.get("ms_per_step")
        rows.append(f"| {arm} | {d.get('steps', '?')} | {_cell(d.get('final_raw'))} | "
                    f"{_cell(d.get('best_raw'))} | {_cell(d.get('final_ema'))} | "
                    f"{_cell(d.get('best_ema'))} | {eps or '—'} | "
                    f"{'—' if ms is None else f'{ms:.1f}'} | {d.get('skipped_updates', '—')} |")
    return rows


def val_table(workdir: str, arm: str, jax_log: str):
    with open(os.path.join(workdir, "logs", f"{arm}.jsonl")) as f:
        port = {int(r["step"]): r for r in map(json.loads, f) if r["event"] == "val"}
    jax = {}
    with open(jax_log) as f:
        for line in f:
            m = re.search(r"\[val\].*step=(\d+).*psnr=([\d.]+) ssim=([\d.]+)", line)
            if m:
                jax[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    rows = [f"| step | port PSNR | port SSIM | JAX PSNR | JAX SSIM | port − JAX dB |",
            "|---|---|---|---|---|---|"]
    for step in sorted(port):
        r = port[step]
        j = jax.get(step)
        rows.append(f"| {step} | {r['psnr']:.3f} | {r['ssim']:.4f} | "
                    + (f"{j[0]:.3f} | {j[1]:.4f} | {r['psnr'] - j[0]:+.3f} |" if j else
                       "— | — | — |"))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--against", action="append", default=[],
                   help="ARM=LOG: the arm's val curve beside a JAX run's log")
    opt = p.parse_args(argv)
    lines = ["# Quality summary — " + os.path.basename(opt.workdir.rstrip("/")), "",
             "PSNR / SSIM (/ lpips_rand where evaluated).", "", *test_table(opt.workdir), ""]
    for spec in opt.against:
        arm, log = spec.split("=", 1)
        lines += [f"## {arm}: val (EMA) against {log}", "", *val_table(opt.workdir, arm, log),
                  ""]
    out = opt.out or os.path.join(opt.workdir, "SUMMARY.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))
    print(f"-> {out}")
    return lines


if __name__ == "__main__":
    main()
