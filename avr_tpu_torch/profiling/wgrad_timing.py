"""What the time of K2's bf16 wgrad depends on, measured on the card.

    python -m avr_tpu_torch.profiling.wgrad_timing [--out=DIR]

At the band call of a train step (327,680 points, d_hidden 512, 5 blocks,
3 latent injections: the 15 jobs ``dW = G^T A`` of ``ops/kernels/resnetfc.py
_wgrad``) it times the wgrad's two kernels (device time from
``torch.profiler``) and ``torch.matmul`` over the same jobs, varying one
thing at a time:

- order: back to back; each call after the dgrad that writes its operands
  (the backward's order); each call after 256 MB written through L2;
- data: the dgrad's cotangents; the same halved (exact in bf16: every
  mantissa kept); zero cotangents; dense random operands of the same shapes;
- plan: ``WGRAD_WAVES`` 1, 2 (the wrapper's) and 4, which sets the number
  of row splits, and so how many float32 partial tiles are written and
  reduced;
- shape: one 512 x 512 job alone, and K3's dW_ih (163,840 rows, 512 x 64);
- host: each wrapper's wall time until it returns, and the part spent in
  its C entry point (the tensor-map encodes and the launches);
- work: the kernel built from a scratch copy of its source with one kind
  of work taken out (its results are then wrong and only timed): the
  second of the two A boxes of every stage not loaded (a quarter fewer
  operand bytes into shared memory, the same products); no ``wgmma``
  (the loads alone); no loads (the products alone).

Each reading is also taken over a loop of about a second, with the card's
SM clock, power draw and clock-event reasons sampled by ``nvidia-smi``
(``mcycles``: the loop's ms a call times the median SM clock, which
compares readings taken at different clocks).  The
whole list runs twice, the second time in reverse order.  Prints one JSON
object a reading and writes every reading to ``DIR/wgrad_timing.json``
(default ``traces/``).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels import resnetfc as K2
from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec, DecoderWeights

BAND_TRAIN, C, DH, NB, NLZ = 327_680, 512, 512, 5, 3
CODE = CodeSpec(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)
K3_ROWS, K3_GATES = 163_840, 64
WGRAD_KERNELS = ("resnetfc_wgrad_wgmma_kernel", "resnetfc_wgrad_reduce_kernel")
SMI_FIELDS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
REASONS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")


def device_ms(fn, names, iters=5):
    """Device ms per call of each named kernel that ``fn`` launches, and of
    everything else it launches (``other``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {n: sum(e.self_device_time_total for e in rows if n in e.key) / 1e3 / iters
           for n in names}
    out["other"] = sum(e.self_device_time_total for e in rows
                       if not any(n in e.key for n in names)) / 1e3 / iters
    return out


def reasons_field():
    """The clock-event reasons' field name that this nvidia-smi accepts, or None."""
    for f in REASONS:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={f}", "--format=csv,noheader"],
                           capture_output=True, text=True)
        if r.returncode == 0 and "Field" not in r.stdout:
            return f
    return None


def sustained(fn, seconds, fields):
    """``fn`` in a loop for about ``seconds``: ms a call (CUDA events) and
    the medians of what ``nvidia-smi`` read meanwhile, with every distinct
    clock-event reason mask seen."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            if r.returncode == 0:
                samples.append([v.strip() for v in r.stdout.strip().splitlines()[0].split(",")])
            stop.wait(0.05)

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=sample)
    th.start()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0, n = time.perf_counter(), 0
    start.record()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        n += 10
        torch.cuda.synchronize()
    end.record()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    out = dict(ms=start.elapsed_time(end) / n, calls=n, samples=len(samples))
    names = fields.split(",")
    for i, name in enumerate(names[:4]):
        vals = [float(s[i]) for s in samples if len(s) > i and s[i].replace(".", "").isdigit()]
        out[name] = float(np.median(vals)) if vals else None
    if out["clocks.sm"]:
        out["mcycles"] = out["ms"] * out["clocks.sm"] / 1e3
    if len(names) > 4:
        out["reasons"] = sorted({s[4] for s in samples if len(s) > 4})
    return out


def host_split(fn, entry, iters=50):
    """Median host ms of one call of ``fn`` on an idle card (its wall time
    until it returns) and of the part spent in its C entry point ``entry``
    (tensor-map encodes and launches)."""
    fn()
    inner = _build._fns[entry]
    spent, total = [], []

    def timed(*args):
        t = time.perf_counter()
        err = inner(*args)
        spent.append(time.perf_counter() - t)
        return err

    _build._fns[entry] = timed
    try:
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            total.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    finally:
        _build._fns[entry] = inner
    return dict(host_ms=float(np.median(total)) * 1e3, entry_ms=float(np.median(spent)) * 1e3)


def decoder_weights(gen, dev):
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    lin = lambda o, i: randn(o, i, scale=i ** -0.5)
    return DecoderWeights(
        lin(DH, CODE.d_enc), randn(DH, scale=0.1),
        torch.stack([lin(DH, C) for _ in range(NLZ)]), randn(NLZ, DH, scale=0.1),
        torch.stack([lin(DH, DH) for _ in range(NB)]), randn(NB, DH, scale=0.1),
        torch.stack([lin(DH, DH) for _ in range(NB)]), randn(NB, DH, scale=0.1),
        lin(4, DH), randn(4, scale=0.1))


def matmul_jobs(st, cot, gout, enc, z):
    """The wgrad's ``(G, A)`` pairs as tensors, in ``K2._wgrad``'s order."""
    jobs = [(cot[K2.stash_slot(k, j, 0, 1, NLZ)], st[K2.stash_slot(k, j, 0, 1, NLZ)])
            for k in range(NB) for j in (0, 1)]
    cot_in = cot[2 * NLZ + 2 * (NB - NLZ)]
    jobs += [(cot_in if k == 0 else cot[K2.stash_slot(k - 1, 1, 0, 1, NLZ)], z[0])
             for k in range(NLZ)]
    return jobs + [(cot_in, enc[0]), (gout[:, :4], st[-1])]


# The wgrad kernel's producer and consumer lines that the variants edit
# (csrc/resnetfc_hopper.cu, resnetfc_wgrad_wgmma_kernel).
_EXPECT = "      mbar_expect_tx(&full[st], WG_STAGE);\n"
_LOADS = """      tma_load_2d(buf, &p.g[j], &full[st], o0, r);
      tma_load_2d(buf + WG_BOX, &p.g[j], &full[st], o0 + 64, r);
      tma_load_2d(buf + 2 * WG_BOX, &p.a[j], &full[st], i0, r);
"""
_LOAD_A2 = "      tma_load_2d(buf + 3 * WG_BOX, &p.a[j], &full[st], i0 + 64, r);\n"
_WGMMA = """      wgmma_m64n128k16<1, 1>(acc, gmma_desc(buf + wg * WG_BOX + kk * 2048, WG_LBO, WG_SBO),
                             gmma_desc(buf + 2 * WG_BOX + kk * 2048, WG_LBO, WG_SBO), 1);
"""
VARIANTS = {
    "committed kernel": [],
    "no second A box": [(_EXPECT, "      mbar_expect_tx(&full[st], 3 * WG_BOX);\n"),
                        (_LOAD_A2, "")],
    "no wgmma": [(_WGMMA, "      ;\n")],
    "no loads": [(_EXPECT + _LOADS + _LOAD_A2, "      mbar_arrive(&full[st]);\n")],
}


@contextlib.contextmanager
def kernel_variant(label):
    """The kernel library built from a copy of ``csrc/`` with
    ``VARIANTS[label]`` (``(old, new)`` string pairs) applied to
    ``resnetfc_hopper.cu``."""
    src, edits = _build.CSRC, VARIANTS[label]
    if edits:
        dst = _build.BUILD_DIR / ("variant_" + label.replace(" ", "_"))
        if not dst.exists():
            dst.mkdir(parents=True)
            for f in src.iterdir():
                (dst / f.name).write_bytes(f.read_bytes())
        path = dst / "resnetfc_hopper.cu"
        text = (src / "resnetfc_hopper.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant edit not found in the source: {old[:60]!r}")
            text = text.replace(old, new)
        path.write_text(text)
        _build.CSRC = dst
    _build._lib = None
    _build._fns.clear()
    try:
        _build.load_library()
        yield
    finally:
        _build.CSRC = src
        _build._lib = None
        _build._fns.clear()


@contextlib.contextmanager
def waves(n):
    old = K2.WGRAD_WAVES
    K2.WGRAD_WAVES = n
    try:
        yield
    finally:
        K2.WGRAD_WAVES = old


def main() -> int:
    if not torch.cuda.is_available():
        print("wgrad_timing: no CUDA device", file=sys.stderr)
        return 1
    out_dir = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--out=")),
                   "traces")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cd = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    w = decoder_weights(gen, dev)
    n = BAND_TRAIN
    x = torch.rand(1, n, CODE.d_raw, generator=gen, device=dev) * 2 - 1
    z = torch.randn(1, n, C, generator=gen, device=dev).to(cd)
    g = torch.randn(n, 4, generator=gen, device=dev) + 0.5
    a = K2._prepare(x, z, w, CODE, cd)
    d = K2._dims(a, NB, NLZ, True)
    st = K2._forward(a, d, cd, True)[1]
    gs, wT, grads = K2._bwd_operands(a, d, g, K2.NAME_DGRAD)
    dx, dz, cot, gout, enc = K2._dgrad(a, d, st, gs, wT, cd)
    dgrad_out = dict(dx=dx, dz=dz, cot=cot, gout=gout, enc=enc)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    field = reasons_field()
    fields = SMI_FIELDS + (f",{field}" if field else "")

    data = {"dgrad's cotangents": (st, cot, gout, enc, a["z"])}

    def operands(kind):
        """The data variants, made when first read (each new one ~3.7 GB)."""
        if kind not in data:
            if kind == "cotangents halved":
                data[kind] = (st, cot * 0.5, gout, enc, a["z"])
            elif kind == "zero cotangents":
                data[kind] = (st, torch.zeros_like(cot), gout, enc, a["z"])
            else:  # dense random operands
                r = lambda t: torch.randn(t.shape, generator=gen, device=dev).to(cd)
                data[kind] = (r(st), r(cot), gout, r(enc), r(a["z"]))
        return data[kind]

    def wgrad(kind="dgrad's cotangents"):
        s_, c_, go_, e_, z_ = operands(kind)
        return lambda: K2._wgrad(n, z_, s_, c_, go_, e_, grads, d, cd)

    def matmul(kind):
        jobs = matmul_jobs(*operands(kind))
        return lambda: [torch.matmul(p.t(), q) for p, q in jobs]

    one_job = (cot[K2.stash_slot(NB - 1, 1, 0, 1, NLZ)], st[K2.stash_slot(NB - 1, 1, 0, 1, NLZ)])
    dw_one = torch.zeros((DH, DH), dtype=torch.float32, device=dev)
    db_one = torch.zeros((DH,), dtype=torch.float32, device=dev)
    v = torch.randn(K3_ROWS, C, generator=gen, device=dev).to(cd)
    dgates = torch.randn(K3_ROWS, K3_GATES, generator=gen, device=dev).to(cd)
    dw_ih = torch.zeros((C, K3_GATES), dtype=torch.float32, device=dev)

    def job_fn(G, A, dW, db):
        return lambda: K2.wgrad("wgrad_timing", [(G.data_ptr(), A.data_ptr(), dW, db, G.shape[0],
                                                  G.shape[1], A.shape[1], dW.shape[0],
                                                  dW.shape[1])], cd, dev)

    def after_dgrad():
        K2._dgrad(a, d, st, gs, wT, cd, out=dgrad_out)
        wgrad()()

    def after_flush():
        flush.add_(1)
        wgrad()()

    # (label, what, the wgrad's call, torch.matmul's call or None, plan waves)
    readings = [
        ("alone", "order", wgrad(), matmul("dgrad's cotangents"), 2),
        ("after the dgrad", "order", after_dgrad, None, 2),
        ("after 256 MB through L2", "order", after_flush, None, 2),
        ("cotangents halved", "data", wgrad("cotangents halved"), matmul("cotangents halved"), 2),
        ("zero cotangents", "data", wgrad("zero cotangents"), matmul("zero cotangents"), 2),
        ("dense random operands", "data", wgrad("dense random operands"),
         matmul("dense random operands"), 2),
        ("waves 1", "plan", wgrad(), None, 1),
        ("waves 4", "plan", wgrad(), None, 4),
        ("one 512 x 512 job", "shape", job_fn(*one_job, dw_one, db_one),
         lambda: torch.matmul(one_job[0].t(), one_job[1]), 2),
        ("K3 dW_ih 163,840 x 512 x 64", "shape", job_fn(v, dgates, dw_ih, None),
         lambda: torch.matmul(v.t(), dgates), 2),
    ]
    results = []
    for rnd, order in enumerate((readings, readings[::-1])):
        for label, what, fn, lib, nw in order:
            with waves(nw):
                r = dict(reading=label, varies=what, round=rnd, waves=nw,
                         device_ms=device_ms(fn, WGRAD_KERNELS),
                         loop=sustained(fn, 1.0, fields))
            if lib is not None:
                r["matmul"] = dict(device_ms=device_ms(lib, ()), loop=sustained(lib, 1.0, fields))
            results.append(r)
            print(json.dumps(r), flush=True)
    # each wrapper's host time and its C entry point's share: the wgrad's
    # entry encodes two tensor maps a job, the dgrad's six
    for label, entry, fn in (
            ("host: wgrad, 15 jobs", "avr_resnetfc_wgrad_bf16", wgrad()),
            ("host: wgrad, K3 dW_ih", "avr_resnetfc_wgrad_bf16", job_fn(v, dgates, dw_ih, None)),
            ("host: dgrad", "avr_resnetfc_dgrad_bf16",
             lambda: K2._dgrad(a, d, st, gs, wT, cd, out=dgrad_out))):
        r = dict(reading=label, varies="host", **host_split(fn, entry))
        results.append(r)
        print(json.dumps(r), flush=True)
    names = list(VARIANTS)
    for rnd, order in enumerate((names, names[::-1])):
        for label in order:
            with kernel_variant(label):
                fn = wgrad()
                r = dict(reading=label, varies="work", round=rnd, waves=K2.WGRAD_WAVES,
                         device_ms=device_ms(fn, WGRAD_KERNELS),
                         loop=sustained(fn, 1.0, fields))
            results.append(r)
            print(json.dumps(r), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "wgrad_timing.json"), "w") as f:
        json.dump({"card": card, "smi_fields": fields, "readings": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
