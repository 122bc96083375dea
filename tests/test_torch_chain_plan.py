"""K2's chain (``avr_tpu_torch/csrc/resnetfc_chain.cu``): its host plan.

The chain runs the decoder product by product over a chunk of points, each
epilogue writing the next product's A operand (a stash slot), and its dgrad
the same products in reverse (``ops/kernels/resnetfc.py chain_plan``).  The
kernels run only on the card; here, on the CPU:

* the plan run record by record in plain PyTorch, each epilogue as the
  kernel's ``epi_pair`` / ``gh_store`` / head / encoding kernels define it:
  the forward equals ``resnetfc_plain`` bit for bit (bf16 and float32, NS 1
  to 3, with and without the stash, every block a view's or some pooled),
  its stash slots are the plain forward's activations, and the dgrad's
  outputs (dx, dz, the cotangent slots, gout, enc) fed to plain wgrads give
  the plain autograd's 12 gradients (float32, 1e-5 of each array's scale);
* the records against the source: ``ChainOp``'s fields, the kinds,
  epilogues and flags, the tiles and shared memory; what the bf16
  products' tensor maps cover (aligned bases, 16-byte strides, K in whole
  boxes) at the shapes the card runs; the workspace's layout; the records
  of a call cut into chunks write every row of every output once.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from avr_tpu_torch.ops.kernels import resnetfc as K2

torch.set_num_threads(2)

SRC = (Path(K2.__file__).resolve().parents[2] / "csrc" / "resnetfc_chain.cu").read_text()
CODE = K2.CodeSpec(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)
N, DH, DL = 37, 64, 64
BF16, F32 = torch.bfloat16, torch.float32

# (views, blocks, injections): one view, views pooled after some blocks,
# every block a view's (no pooled block), a single block
SHAPES = [(1, 3, 2), (2, 3, 2), (3, 3, 1), (2, 2, 2), (1, 1, 1), (3, 4, 3)]


def _weights(seed, nb, nlz, dh=DH, dl=DL, d_out=4):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, fan: torch.randn(*s, generator=gen) * fan ** -0.5
    d_enc = CODE.d_enc
    return K2.DecoderWeights(r(dh, d_enc, fan=d_enc), r(dh, fan=4), r(nlz, dh, dl, fan=dl),
                             r(nlz, dh, fan=4), r(nb, dh, dh, fan=dh), r(nb, dh, fan=4),
                             r(nb, dh, dh, fan=dh), r(nb, dh, fan=4), r(d_out, dh, fan=dh),
                             r(d_out, fan=4))


def _inputs(seed, ns):
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(ns, N, CODE.d_raw, generator=gen) * 2 - 1
    return x, torch.randn(ns, N, DL, generator=gen), torch.randn(N, 4, generator=gen) + 0.5


def _emulate(steps, x, z, w, cd, nb, nlz, stash=True, st=None, g=None, activate=True):
    """Run the records of ``chain_plan`` in plain PyTorch, as the kernels
    define each record (forward: returns out and the stash or the operand
    buffers; dgrad on ``st``: dx, dz, cot, gout, enc)."""
    c = lambda t: t.to(cd).float()
    ns, n = x.shape[:2]
    dh = w.wi.shape[0]
    W = dict(wi=c(w.wi), wz=c(w.wz), w0=c(w.w0), w1=c(w.w1))
    B = dict(wi=c(w.bi), wz=c(w.bz), w0=c(w.b0), w1=c(w.b1))
    wo, bo = c(w.wo), c(w.bo)
    inv = 1.0 / ns
    H, pool = torch.zeros(n, dh), torch.zeros(n, dh)
    slots = K2.stash_slots(ns, nb, nlz)
    bufs = dict(stash=torch.zeros(slots, n, dh) if st is None else st.float(),
                act=torch.zeros(2, n, dh), cot=torch.zeros(K2.cot_slots(ns, nb, nlz), n, dh),
                dz=torch.zeros(ns, n, DL))
    denc = None
    dx, enc = torch.zeros(ns, n, CODE.d_raw), torch.zeros(ns, n, CODE.d_enc)
    gout = torch.zeros(n, K2.GOUT_W)
    out = None

    def get(ref):
        if ref[0] == "encoded":
            return bufs["encoded"]
        if ref[0] == "z":
            return c(z[ref[1]])
        return bufs[ref[0]][ref[1]]

    def put(ref, v):
        bufs[ref[0]][ref[1]] = c(v)

    def linout_pre(a):
        return a @ wo.T + bo

    for s in steps:
        if s.kind == "linout":
            o = linout_pre(get(s.a))
            if activate:
                o = torch.cat([torch.sigmoid(o[:, :3]), torch.relu(o[:, 3:])], -1)
            out = o
            continue
        if s.kind == "head":
            aout = get(s.a)
            ge = g.clone()
            if activate:
                pre = linout_pre(aout)
                sg = torch.sigmoid(pre[:, :3])
                ge = torch.cat([ge[:, :3] * sg * (1 - sg),
                                torch.where(pre[:, 3:] > 0, ge[:, 3:], 0.0)], -1)
            ge = c(ge)
            gout[:, :ge.shape[1]] = ge
            H = _gh_store(s, torch.where(aout > 0, ge @ wo, 0.0), bufs, ns, inv, c)
            if s.pool == "boundary":
                pool = H
            continue
        if s.kind == "enc" and s.out is not None:  # the forward's encoding pass
            bufs["encoded"] = c(K2.encode_features(x[s.view], CODE))
            continue
        if s.kind == "enc":
            v = s.view
            enc[v] = c(K2.encode_features(x[v], CODE))
            xe = x[v].clone().requires_grad_(True)
            e = K2.encode_features(xe, CODE)
            dx[v] = torch.autograd.grad(e, xe, denc)[0]
            continue
        name = s.w[0]
        k = s.w[1] if len(s.w) > 1 else 0
        if s.nseg > 1:  # dz: one sum over the injections' segments
            acc = sum(get(s.a if j == 0 else (s.a1[0], s.a1[1] + (j - 1) * s.a_seg)) @ W[name][j]
                      for j in range(s.nseg))
        elif s.epi in ("c0", "gh", "f32", "t"):
            acc = get(s.a) @ (W[name][k] if name != "wi" else W[name])
        else:
            acc = get(s.a) @ (W[name][k] if name != "wi" else W[name]).T
        b = None
        if s.epi in ("in", "z", "fc0", "fc1"):
            b = B[name][k] if name != "wi" else B[name]
        if s.epi == "in":
            H = acc + b
        elif s.epi == "z":
            H = (H + acc) + b
            put(s.out, torch.relu(H))
        elif s.epi == "fc0":
            put(s.out, torch.relu(acc + b))
        elif s.epi == "fc1":
            h = (H + acc) + b
            if s.pool == "first":
                pool = h
            elif s.pool == "add":
                pool = pool + h
            else:
                if s.pool == "last":
                    h = (pool + h) * inv
                H = h
            if s.out is not None:
                put(s.out, torch.relu(h))
        elif s.epi == "c0":
            put(s.out, torch.where(get(s.mask) > 0, acc, 0.0))
        elif s.epi == "gh":
            base = pool * inv if s.pool == "use" else H
            H = _gh_store(s, torch.where(get(s.mask) > 0, base + acc, base), bufs, ns, inv, c)
            if s.pool == "boundary":
                pool = H
        elif s.epi == "f32":
            denc = acc[:, :CODE.d_enc]
        else:
            put(s.out, acc)
    if g is None:
        return out, bufs["stash"] if stash else bufs["act"]
    return dx, bufs["dz"], bufs["cot"], gout, enc


def _gh_store(s, gh, bufs, ns, inv, c):
    """``gh_store``: the trunk cotangent and round(gh) to the next c1 (or
    cot_in); at the boundary the pooled cotangent and every view's first c1.
    Returns the new H (the pooled cotangent at the boundary)."""
    if s.pool == "boundary":
        for v in range(ns):
            bufs[s.out[0]][s.out[1] + v] = c(gh * inv)
        return gh
    bufs[s.out[0]][s.out[1]] = c(gh)
    return gh


def _plain_stash(x, z, w, nb, nlz, cd):
    """The plain forward's post-ReLU activations in stash-slot order."""
    c = lambda t: t.to(cd).float()
    wi, bi, wz, bz, w0, b0, w1, b1, wo, bo = (c(t) for t in w)
    ns = x.shape[0]
    st = torch.zeros(K2.stash_slots(ns, nb, nlz), x.shape[1], wi.shape[0])

    def block(h, k, v):
        a1 = c(torch.relu(h))
        st[K2.stash_slot(k, 0, v, ns, nlz)] = a1
        a2 = c(torch.relu(a1 @ w0[k].T + b0[k]))
        st[K2.stash_slot(k, 1, v, ns, nlz)] = a2
        return h + a2 @ w1[k].T + b1[k]

    hs = None
    for v in range(ns):
        h = c(K2.encode_features(x[v], CODE)) @ wi.T + bi
        for k in range(nlz):
            h = block(h + c(z[v]) @ wz[k].T + bz[k], k, v)
        hs = h if hs is None else hs + h
    h = hs if ns == 1 else hs * (1.0 / ns)
    for k in range(nlz, nb):
        h = block(h, k, 0)
    st[-1] = c(torch.relu(h))
    return st


@pytest.mark.parametrize("cd", [BF16, F32])
@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("ns,nb,nlz", SHAPES)
def test_chain_forward_is_the_plain_function(ns, nb, nlz, stash, cd):
    w = _weights(ns * 10 + nb + nlz, nb, nlz)
    x, z, _ = _inputs(nb, ns)
    steps = K2.chain_plan(ns, nb, nlz, backward=False, stash=stash)
    got, st = _emulate(steps, x, z, w, cd, nb, nlz, stash=stash)
    want = K2.resnetfc_plain(x, z, w, n_blocks=nb, n_lin_z=nlz, compute_dtype=cd, code=CODE,
                             activate_out=True)
    assert torch.equal(got, want)
    if stash:
        assert torch.equal(st, _plain_stash(x, z, w, nb, nlz, cd))
    # every product is a gemm record but lin_out; the stash slots each
    # written once, by the product that makes them
    outs = [s.out for s in steps if s.kind == "gemm" and s.out is not None]
    if stash:
        assert sorted(o[1] for o in outs) == list(range(K2.stash_slots(ns, nb, nlz)))
    assert sum(s.kind == "gemm" for s in steps) == ns * (1 + 3 * nlz) + 2 * (nb - nlz)


def _wgrads(st, cot, gout, enc, z, ns, nb, nlz):
    """The wgrads' jobs (``_wgrad``) as plain products: dW = G^T A, db =
    sum G, in float32."""
    n = z.shape[1]
    rows = lambda t, i, count: t[i:i + count].reshape(-1, t.shape[-1])
    g = {}
    for k in range(nb):
        count = ns if k < nlz else 1
        for j, (wk, bk) in enumerate((("w0", "b0"), ("w1", "b1"))):
            s = K2.stash_slot(k, j, 0, ns, nlz)
            G, A = rows(cot, s, count), rows(st, s, count)
            g.setdefault(wk, []).append(G.T @ A)
            g.setdefault(bk, []).append(G.sum(0))
    cin = K2.cot_slots(ns, nb, nlz) - ns
    for k in range(nlz):
        G = rows(cot, cin if k == 0 else K2.stash_slot(k - 1, 1, 0, ns, nlz), ns)
        g.setdefault("wz", []).append(G.T @ z.reshape(-1, z.shape[-1]))
        g.setdefault("bz", []).append(G.sum(0))
    G = rows(cot, cin, ns)
    g["wi"], g["bi"] = G.T @ enc.reshape(-1, enc.shape[-1]), G.sum(0)
    g["wo"], g["bo"] = gout[:, :4].T @ st[-1], gout[:, :4].sum(0)
    return {k: torch.stack(v) if isinstance(v, list) else v for k, v in g.items()}


@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("ns,nb,nlz", SHAPES)
def test_chain_dgrad_gives_the_plain_gradients(ns, nb, nlz, activate):
    """float32: the dgrad's records on the plain stash, then plain wgrads on
    its outputs, against autograd through ``resnetfc_plain``."""
    w = _weights(ns * 7 + nb, nb, nlz)
    x, z, g = _inputs(nlz, ns)
    st = _plain_stash(x, z, w, nb, nlz, F32)
    steps = K2.chain_plan(ns, nb, nlz, backward=True)
    dx, dz, cot, gout, enc = _emulate(steps, x, z, w, F32, nb, nlz, st=st, g=g,
                                      activate=activate)
    got = _wgrads(st, cot, gout, enc, z, ns, nb, nlz)
    leaves = [t.clone().requires_grad_(True) for t in (x, z, *w)]
    out = K2.resnetfc_plain(leaves[0], leaves[1], K2.DecoderWeights(*leaves[2:]), n_blocks=nb,
                            n_lin_z=nlz, compute_dtype=F32, code=CODE, activate_out=activate)
    want = torch.autograd.grad(out, leaves, g)
    names = ("wi", "bi", "wz", "bz", "w0", "b0", "w1", "b1", "wo", "bo")
    for name, a, b in zip(("dx", "dz") + names, (dx, dz, *(got[k] for k in names)), want):
        scale = max(float(b.abs().max()), 1e-12)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)


def test_chain_records_match_the_source():
    """``ChainOp`` is the source's record field for field (names, order,
    types), and the kinds, epilogues and flags are the source's enums."""
    body = re.search(r"struct ChainOp \{(.+?)\n\};", SRC, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
             "const int*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.match(r"(const void\*|void\*|const float\*|float\*|const int\*|long long|int|"
                     r"float) (.+)", decl)
        fields += [(name.strip(), types[m.group(1)]) for name in m.group(2).split(",")]
    assert fields == [(n, t) for n, t in K2.ChainOp._fields_]
    assert ctypes.sizeof(K2.ChainOp) == 240

    def enum(first):
        block = re.search(r"enum \{\s*" + first + r"[^}]*\}", SRC).group(0)
        return {m[0]: int(m[1]) for m in re.findall(r"(\w+) = (\d+)", block)}

    assert enum("OP_GEMM") == {"OP_" + k.upper(): v for k, v in K2.CHAIN_KINDS.items()}
    epi = {"in": "IN", "z": "Z", "fc0": "FC0", "fc1": "FC1", "c0": "C0", "gh": "GH", "f32": "F32",
           "t": "T"}
    assert enum("EPI_IN") == {"EPI_" + epi[k]: v for k, v in K2.CHAIN_EPI.items()}
    flag = {"use": "USE_POOL", "boundary": "BOUNDARY", "first": "POOL_FIRST", "add": "POOL_ADD",
            "last": "POOL_LAST"}
    assert enum("F_USE_POOL") == {"F_" + flag[k]: v for k, v in K2.CHAIN_FLAGS.items()}


def _constants():
    env = {"sizeof(bf16)": 2, "sizeof(float)": 4}
    for line in re.findall(r"^constexpr int (C[HFW]_\w+ = [^;]+);", SRC, re.M):
        for part in " ".join(line.split()).split(", "):
            name, expr = part.split(" = ", 1)
            expr = expr.replace("(int)sizeof(bf16)", "2").replace("(int)sizeof(float)", "4")
            env[name] = eval(expr, {}, dict(env))  # noqa: S307 - the repo's own constants
    return env


def test_chain_tiles_fit_the_card():
    """The bf16 products' kernel: its ring of stages (an A box and a B box
    each) and its barriers within an SM's 227 KB, every box 1024-byte
    aligned (the 128-byte swizzle's period; warpgroup 1's rows too), a box
    row one 128-byte swizzle row, the expected bytes of a stage its two
    boxes, a TMA box at most 256 rows; its tile two warpgroups of
    ``m64n256k16`` (64 rows each, 256 columns, k steps of 16) and a producer
    warpgroup; the epilogue's load groups whole 8-column groups of the
    fragment.  The float32 kernel: its ring (an A box and a B box a stage)
    and barriers within an SM's 227 KB at one CTA an SM, the launch bound
    of two consumer warpgroups and a producer warpgroup at one CTA an SM,
    their registers within the SM's (``setmaxnreg``); a
    thread's CF_TM x CF_TN outputs tile a warp's 64 x 64 and the warps the
    CTA's (4 x 2); a stage's k divides every K the chain takes (multiples of
    64); its raw A ring and k-major stages (an A tile and a B box each)
    whole 128-byte units, every box's rows 16-byte aligned, every box at
    most 256 rows, the three transposing warps counted on the barriers;
    each consumer warp's epilogue buffer (8 rows of 64 columns) after the
    barriers, its rows 16-byte aligned;
    a chunk fits the grid (every tile and warp block an int)."""
    e = _constants()
    assert e["CW_SMEM"] == 196_672 and e["CF_SMEM"] == 168_048
    assert e["CW_SMEM"] == e["CW_STAGES"] * e["CW_STAGE"] + 2 * e["CW_STAGES"] * 8 <= K2.SMEM_MAX
    assert e["CF_BAR"] == e["CF_STAGES"] * e["CF_STAGE"] + e["CF_RAW"] * e["CF_A"]
    assert e["CF_EPI"] == e["CF_BAR"] + 2 * (e["CF_STAGES"] + e["CF_RAW"]) * 8
    assert e["CF_SMEM"] == e["CF_EPI"] + 8 * e["CF_EPI_WARP"] <= K2.SMEM_MAX
    assert e["CF_EPI_WARP"] == 8 * e["CF_EPI_LD"] * 4 and e["CF_EPI_LD"] >= 64
    assert e["CF_EPI"] % 16 == 0 and (e["CF_EPI_LD"] * 4) % 16 == 0
    assert e["CW_STAGES"] >= 3 and e["CF_STAGES"] >= 3 and e["CF_RAW"] >= 2
    assert e["CW_A"] == e["CW_BM"] * e["CW_BK"] * 2
    assert e["CW_STAGE"] == (e["CW_BM"] + e["CW_BN"]) * e["CW_BK"] * 2
    assert e["CW_A"] % 1024 == 0 and (e["CW_A"] // 2) % 1024 == 0 and e["CW_STAGE"] % 1024 == 0
    assert e["CW_BAR"] == e["CW_STAGES"] * e["CW_STAGE"] and e["CW_BAR"] % 8 == 0
    assert e["CW_BK"] * 2 == 128 and e["CW_BK"] % 16 == 0 and max(e["CW_BM"], e["CW_BN"]) <= 256
    assert e["CW_BM"] == 2 * 64 and e["CW_BN"] == 256 and e["CW_THREADS"] == 3 * 128
    assert (e["CW_BN"] // 8) % e["CW_EPI_GROUPS"] == 0
    assert "wgmma_m64n256k16<0, 0>" in SRC and "mbar_init(&empty[s], 256)" in SRC
    assert e["CF_THREADS"] == 3 * 128 and 128 * 40 + 256 * 232 <= 65_536
    assert "setmaxnreg_dec<40>" in SRC and "setmaxnreg_inc<232>" in SRC
    assert (e["CF_THREADS"] - 128) * e["CF_TM"] * e["CF_TN"] == e["CF_BM"] * e["CF_BN"]
    assert 8 * e["CF_TM"] == 64 and 4 * e["CF_TN"] == 64  # a warp's 8 x 4 lanes
    assert e["CF_BM"] == 4 * 64 and e["CF_BN"] == 2 * 64 and e["CF_TN"] % 4 == 0
    assert 64 % e["CW_BK"] == 0 and 64 % e["CF_BK"] == 0 and e["CF_BK"] % 4 == 0
    assert e["CF_A"] == e["CF_BM"] * e["CF_BK"] * 4 and (e["CF_BK"] * 4) % 16 == 0
    assert e["CF_STAGE"] == e["CF_A"] + e["CF_BK"] * e["CF_BN"] * 4
    assert e["CF_A"] % 128 == 0 and e["CF_STAGE"] % 128 == 0 and (e["CF_BN"] * 4) % 16 == 0
    assert e["CF_BAR"] % 8 == 0 and max(e["CF_BM"], e["CF_BN"], e["CF_BK"]) <= 256
    # the transposing warps: the producer warpgroup's three after its first,
    # each stage's 4 x 4 blocks among them; the full barrier counts them
    assert "mbar_init(&full[s], 1 + 96)" in SRC and "mbar_init(&raw_empty[s], 96)" in SRC
    assert "mbar_init(&empty[s], 256)" in SRC
    rows = e["CH_ROWS_MAX"]
    assert K2.CHAIN_CHUNK <= rows and -(-rows // e["CF_BM"]) * -(-4096 // e["CF_BN"]) < 2 ** 31
    assert -(-rows // e["CW_BM"]) * -(-4096 // e["CW_BN"]) < 2 ** 31 and (rows + 7) // 8 < 2 ** 31
    assert "__launch_bounds__(CW_THREADS, 1)\nchain_gemm_wgmma_kernel" in SRC
    assert "__launch_bounds__(CF_THREADS, 1)\nchain_gemm_f32_kernel" in SRC


class _At:
    """A tensor's stand-in for ``_chain_records``: a base address."""

    def __init__(self, ptr):
        self.ptr = ptr

    def data_ptr(self):
        return self.ptr


# (dtype, d_hidden, d_latent): chip_smoke.py CHAIN_CASES, the shapes the card
# runs on the chain, with the sweep's moved corners A1, B1, C4 and D1 (its
# 1,088 encoded lanes in CARD_K_IN; the others take 64)
CARD_CASES = [(BF16, 1280, 1152), (BF16, 2048, 1152), (BF16, 1024, 4096), (F32, 1920, 1152),
              (BF16, 512, 4096), (BF16, 64, 1216), (BF16, 576, 2112), (BF16, 192, 4096),
              (F32, 1024, 1152)]
CARD_K_IN = {(F32, 1024, 1152): 1088}


@pytest.mark.parametrize("pass_", ["forward", "forward_no_stash", "dgrad"])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("cd,dh,dl", CARD_CASES)
def test_tensor_maps_cover_whole_aligned_boxes(monkeypatch, cd, dh, dl, ns, pass_):
    """Every product record at the card's shapes, the call cut into
    384-point chunks (N off every tile): what the bf16 kernel's tensor maps
    cover has a 16-byte-aligned base (each segment's, ``a_seg`` and
    ``b_seg`` apart), 16-byte row and segment strides, and K and the output
    columns in whole 64-wide boxes; the float32 kernel's tensor maps the
    same bases and strides, K in whole 32-k boxes, and its epilogue's
    16-byte groups whole: the bias, trunk, view-sum, output and mask bases
    16-byte aligned, their row strides and the views' output stride
    multiples of 4 floats, as ``launch_op`` requires."""
    monkeypatch.setattr(K2, "CHAIN_CHUNK", 384)
    n, nb, nlz, k_in = 81_920 + 37, 5, 3, CARD_K_IN.get((cd, dh, dl), 64)
    backward, stash = pass_ == "dgrad", pass_ != "forward_no_stash"
    item = 2 if cd == BF16 else 4
    d = dict(N=n, ns=ns, d_in=CODE.d_raw, k_in=k_in, d_latent=dl, d_hidden=dh, d_out=4,
             n_blocks=nb, n_lin_z=nlz, activate=1)
    names = ("x", "z", "stash", "cot", "wi", "wz", "w0", "w1", "bi", "bz", "b0", "b1", "wo", "bo",
             "tables", "fph", "out", "g", "gout", "dx", "dz", "enc")
    t = {k: _At((i + 1) << 36) for i, k in enumerate(names)}
    off = K2.chain_workspace(n, ns, dh, k_in, cd, stash, backward)
    assert all(v % 16 == 0 for v in off.values() if isinstance(v, int))
    steps = K2.chain_plan(ns, nb, nlz, backward=backward, stash=stash)
    gemms = 0
    for s in range(0, n, K2.CHAIN_CHUNK):
        m = min(K2.CHAIN_CHUNK, n - s)
        for r in K2._chain_records(steps, t, d, s, m, (1 << 40, off), cd, backward):
            if r.kind != K2.CHAIN_KINDS["gemm"]:
                continue
            gemms += 1
            assert r.M == m and r.K % 64 == 0 and r.Ncols % 64 == 0 and r.nseg >= 1
            assert (r.lda * item) % 16 == 0 and (r.ldb * item) % 16 == 0
            bases = [r.A] + [r.A1 + j * r.a_seg * item for j in range(r.nseg - 1)]
            bases += [r.B + j * r.b_seg * item for j in range(r.nseg)]
            assert all(b and b % 16 == 0 for b in bases), (r.epi, bases)
            if r.nseg > 1:
                assert (r.a_seg * item) % 16 == 0 and (r.b_seg * item) % 16 == 0
            if cd == F32:
                assert r.K % _constants()["CF_BK"] == 0 and r.Ncols % 4 == 0
                assert all(p % 16 == 0 for p in (r.bias or 0, r.H, r.pool, r.out or 0,
                                                 r.mask or 0)), r.epi
                assert r.ldh % 4 == 0 and r.ldo % 4 == 0 and r.ldm % 4 == 0
                assert r.out_view % 4 == 0
    assert gemms == len([st for st in steps if st.kind == "gemm"]) * -(-n // 384)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("stash", [True, False])
def test_chain_workspace_layout(backward, stash):
    """The workspace: the float32 trunk (or gh), the view sums (NS > 1), the
    forward's encoded input and its two operand buffers without the stash,
    the dgrad's lin_in input cotangent; sized by the chunk, not by N."""
    for ns in (1, 2):
        for cd, item in ((BF16, 2), (F32, 4)):
            for n in (1_000, K2.CHAIN_CHUNK, 10 * K2.CHAIN_CHUNK):
                c = min(n, K2.CHAIN_CHUNK)
                off = K2.chain_workspace(n, ns, 2048, 192, cd, stash, backward)
                want = 4 * c * 2048 * (2 if ns > 1 else 1)
                if backward:
                    assert off["denc"] == want and "encoded" not in off
                    want += 4 * c * 192
                else:
                    assert off["encoded"] == want
                    want += item * c * 192
                if not stash and not backward:
                    assert off["act"] == (want, want + item * c * 2048)
                    want += 2 * item * c * 2048
                assert off["bytes"] == want and off["H"] == 0 and off["pool"] == 4 * c * 2048
                assert all(v % 16 == 0 for v in off.values() if isinstance(v, int))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("ns", [1, 2])
def test_chunked_records_cover_every_row_once(monkeypatch, backward, ns):
    """A call cut into chunks (the chunk made 16 points): the records'
    outputs in device memory (stash or cotangent slots, dz, dx, enc, gout,
    out) cover each row of each output once, each chunk's rows at its own
    offset, and every A operand and mask lies inside its tensor."""
    monkeypatch.setattr(K2, "CHAIN_CHUNK", 16)
    nb, nlz, n, dh, cd = 3, 2, 37, 64, BF16
    item = 2
    d = dict(N=n, ns=ns, d_in=CODE.d_raw, k_in=64, d_latent=DL, d_hidden=dh, d_out=4,
             n_blocks=nb, n_lin_z=nlz, activate=1)
    t = dict(x=torch.zeros(ns, n, CODE.d_raw), z=torch.zeros(ns, n, DL, dtype=cd),
             stash=torch.zeros(K2.stash_slots(ns, nb, nlz), n, dh, dtype=cd),
             cot=torch.zeros(K2.cot_slots(ns, nb, nlz), n, dh, dtype=cd),
             wi=torch.zeros(dh, 64, dtype=cd), wz=torch.zeros(nlz, dh, DL, dtype=cd),
             w0=torch.zeros(nb, dh, dh, dtype=cd), w1=torch.zeros(nb, dh, dh, dtype=cd),
             bi=torch.zeros(dh), bz=torch.zeros(nlz, dh), b0=torch.zeros(nb, dh),
             b1=torch.zeros(nb, dh), wo=torch.zeros(4, dh, dtype=cd), bo=torch.zeros(4),
             tables=torch.zeros(2, 64, dtype=torch.int32), fph=torch.zeros(2, 64),
             out=torch.zeros(n, 4), g=torch.zeros(n, 4), gout=torch.zeros(n, 8, dtype=cd),
             dx=torch.zeros(ns, n, CODE.d_raw), dz=torch.zeros(ns, n, DL, dtype=cd),
             enc=torch.zeros(ns, n, 64, dtype=cd))
    off = K2.chain_workspace(n, ns, dh, 64, cd, True, backward)
    assert off["bytes"] == 4 * 16 * dh * (2 if ns > 1 else 1) + (4 if backward else item) * 16 * 64
    steps = K2.chain_plan(ns, nb, nlz, backward=backward)
    rows = {}  # (tensor, row byte offset) -> writes

    def mark(name, ptr, m, width, size, views=1, view_step=0):
        base = t[name].data_ptr()
        for v in range(views):
            start = ptr + v * view_step * size - base
            assert start % (width * size) == 0
            r0 = start // (width * size)
            assert 0 <= r0 and r0 + m <= t[name].numel() // width
            for r in range(r0, r0 + m):
                rows[(name, r)] = rows.get((name, r), 0) + 1

    def inside(name, ptr, m, width, size):
        base = t[name].data_ptr()
        assert base <= ptr and ptr + m * width * size <= base + t[name].numel() * size

    chunks = 0
    for s in range(0, n, 16):
        m = min(16, n - s)
        chunks += 1
        recs = K2._chain_records(steps, t, d, s, m, (1 << 40, off), cd, backward)
        assert len(recs) == len(steps)
        for st, r in zip(steps, recs):
            assert r.M == m
            if st.kind == "linout":
                mark("out", r.outf, m, 4, 4)
            elif st.kind == "head":
                mark("gout", r.gout, m, 8, item)
            elif st.kind == "enc" and not backward:  # the encoding pass: the workspace
                assert not r.dx and r.enc == (1 << 40) + off["encoded"]
            elif st.kind == "enc":
                mark("dx", r.dx, m, CODE.d_raw, 4)
                mark("enc", r.enc, m, 64, item)
            if st.out is not None and st.out[0] in ("stash", "cot", "dz"):
                name = st.out[0]
                width = DL if name == "dz" else dh
                views = ns if st.pool == "boundary" else 1
                mark(name, r.out, m, width, item, views, r.out_view)
            if st.a is not None and st.a[0] in ("stash", "cot", "z"):
                inside(st.a[0], r.A, m, DL if st.a[0] == "z" else dh, item)
            if st.mask is not None:
                inside("stash", r.mask, m, dh, item)
    assert chunks == 3
    if backward:
        want = {"cot": K2.cot_slots(ns, nb, nlz) * n, "dz": ns * n, "dx": ns * n, "enc": ns * n,
                "gout": n}
    else:
        want = {"stash": K2.stash_slots(ns, nb, nlz) * n, "out": n}
    for name, count in want.items():
        got = {r: k for (nm, r), k in rows.items() if nm == name}
        assert len(got) == count and set(got.values()) == {1}, name
