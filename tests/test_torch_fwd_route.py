"""K2's forward routing and the bf16 wgmma forward's host-side plan.

``forward_route`` (``ops/kernels/resnetfc.py``) decides which forward kernel
a call launches on the card: the main path's shapes (bf16, ``d_latent`` 512,
64 encoded input lanes) go to the wgmma kernel (``csrc/resnetfc_hopper.cu
resnetfc_fwd_wgmma_kernel``), and so do bf16 latents and encoded inputs up
to ``FWD_OPERAND_MAX`` lanes (in pieces of up to 768); wider bf16 shapes go to
the chain (``csrc/resnetfc_chain.cu``), float32 to ``csrc/resnetfc.cu``'s
FMA kernel, never to a refusal.  The
wgmma kernel's shared-memory layout, read from its source's constants
(``csrc/resnetfc_hopper.cu``: ``DG_M``..``DG_SMEM`` at :102-111 by the
walk's names, ``FWD_K_MAX``, ``FW_STAGES`` and ``FW_PARK`` at :559-564),
must fit the card's 227 KB with each swizzled tile 1,024-byte aligned.  The
stash slots the kernel stores (``stash_slot`` at :688-689 and the last slot
at :841) come from ``resnetfc.cuh stash_slot``, which must equal the
Python mirror and fill every slot once.
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

from avr_tpu_torch.ops.kernels import resnetfc as K2

CSRC = Path(K2.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use (227 KB)
ROUTES = ("wgmma", "chain", "fma")


def _constants():
    """The layout constants of csrc/resnetfc_hopper.cu, evaluated in order."""
    src = (CSRC / "resnetfc_hopper.cu").read_text()
    env = {"GOUT_W": int(re.search(r"constexpr int GOUT_W = (\d+);",
                                   (CSRC / "resnetfc.cuh").read_text()).group(1))}
    for name, expr in re.findall(
            r"^constexpr (?:int|uint32_t) ((?:DG|FW|FWD)_\w+) = ([^;]+);", src, re.M):
        env[name] = eval(expr, {}, dict(env))  # noqa: S307 - the repo's own constants
    return env


def test_main_path_takes_the_wgmma_kernel():
    assert K2.forward_route(torch.bfloat16, 512, 64) == "wgmma"


@pytest.mark.parametrize("d_latent,k_in", [(512, 64), (1024, 576)])
def test_float32_takes_the_fma_kernel(d_latent, k_in):
    assert K2.forward_route(torch.float32, d_latent, k_in) == "fma"


def test_the_shipped_decoder_is_inside_the_envelope():
    """conf/default.conf's decoder: 6 frequencies of 3 coded lanes with the
    input and 3 passthrough lanes (42, padded to 64), latent 512."""
    code = K2.CodeSpec(num_freqs=6, freq_factor=1.5, include_input=True, d_coded=3, d_pass=3)
    k_in = K2.d_enc_padded(code.d_enc)
    assert k_in == 64
    assert K2.forward_route(torch.bfloat16, 512, k_in) == "wgmma"


@pytest.mark.parametrize("d_latent,k_in", [(1024, 64), (576, 64), (512, 576), (1024, 1024),
                                           (1216, 64), (512, 1216)])
def test_every_accepted_shape_has_a_kernel(d_latent, k_in):
    """bf16 beyond the wgmma kernel's 512-lane A tile takes its pieces up to
    FWD_OPERAND_MAX lanes and the chain past them (measured faster than the
    retired ``mma.sync`` kernel that took them before: chip_smoke.py
    --chain-sweep, family A); nothing the wrapper takes is refused on the
    card."""
    pieced = max(d_latent, k_in) <= K2.FWD_OPERAND_MAX
    assert K2.forward_route(torch.bfloat16, d_latent, k_in) == ("wgmma" if pieced else "chain")
    for cd, dl, kin in itertools.product((torch.bfloat16, torch.float32),
                                         range(64, 1217, 64), range(64, 1217, 64)):
        assert K2.forward_route(cd, dl, kin) in ROUTES


def test_the_envelope_matches_the_kernel():
    """The wrapper's envelope and tile are the kernel's, and its A tile holds
    FWD_K_MAX lanes of 64 points; the chain takes the bf16 forward exactly
    past the C entry's FWD_OPERAND_MAX lanes."""
    c = _constants()
    assert K2.FWD_K_MAX == c["FWD_K_MAX"]
    assert K2.FWD_OPERAND_MAX == c["FWD_OPERAND_MAX"]
    for dh in (64, 256, 512):
        assert not K2.chain_takes(torch.bfloat16, dh, K2.FWD_OPERAND_MAX, K2.FWD_OPERAND_MAX)
        assert K2.chain_takes(torch.bfloat16, dh, K2.FWD_OPERAND_MAX + 64, 64)
        assert K2.chain_takes(torch.bfloat16, dh, 64, K2.FWD_OPERAND_MAX + 64)
    assert K2.FWD_TILE == c["DG_M"]
    assert (c["DG_W"] - c["DG_A"]) // c["DG_BOX"] * 64 >= c["FWD_K_MAX"]
    assert c["DG_BOX"] == c["DG_M"] * 64 * 2  # a box: 64 points x 64 bf16 lanes


def test_shared_memory_fits_every_routed_shape():
    """The A tile, the weight ring, the park tiles and the barriers lie in
    order without overlap, and the block fits 227 KB.  The layout is the
    same for every shape routed to the kernel."""
    c = _constants()
    ring_end = c["DG_W"] + c["FW_STAGES"] * 2 * c["DG_SLAB"]
    park_end = c["FW_PARK"] + 2 * 2 * c["DG_BOX"]
    barriers = 2 * c["FW_STAGES"] + 1  # full, empty, the latent tile's
    assert c["DG_A"] + 8 * c["DG_BOX"] <= c["DG_W"]
    assert ring_end <= c["FW_PARK"] and park_end <= c["DG_BAR"]
    assert c["DG_BAR"] + 8 * barriers <= c["DG_SMEM"] <= SMEM_LIMIT


def test_swizzled_tiles_are_1024_byte_aligned():
    c = _constants()
    box, slab = c["DG_BOX"], c["DG_SLAB"]
    tiles = [c["DG_A"] + b * box for b in range(8)]
    tiles += [c["DG_W"] + s * 2 * slab + g * slab for s in range(c["FW_STAGES"]) for g in (0, 1)]
    tiles += [c["FW_PARK"] + g * 2 * box + h * box for g in (0, 1) for h in (0, 1)]
    assert all(off % 1024 == 0 for off in tiles), tiles


def _cuh_stash_slot():
    """resnetfc.cuh's stash_slot, its C expression read from the header."""
    src = (CSRC / "resnetfc.cuh").read_text()
    m = re.search(r"inline int stash_slot\(int k, int j, int v, int ns, int n_lin_z\) \{\s*"
                  r"return ([^?]+)\?([^:]+):([^;]+);", src)
    cond, yes, no = (g.strip() for g in m.groups())
    return eval(f"lambda k, j, v, ns, n_lin_z: ({yes}) if ({cond}) else ({no})")  # noqa: S307


@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("n_blocks,n_lin_z", [(5, 3), (5, 5), (3, 1)])
def test_stash_slots_written_are_the_headers(ns, n_blocks, n_lin_z):
    """Per view each pre-pool block's relu(h) and relu(fc_0), then the
    post-pool blocks' (view 0), then the trunk's end in the last slot: every
    slot once, the header's slot equal to the Python mirror's."""
    slot = _cuh_stash_slot()
    keys = [(k, j, v) for v in range(ns) for k in range(n_lin_z) for j in (0, 1)]
    keys += [(k, j, 0) for k in range(n_lin_z, n_blocks) for j in (0, 1)]
    written = [slot(k, j, v, ns, n_lin_z) for k, j, v in keys]
    written.append(K2.stash_slots(ns, n_blocks, n_lin_z) - 1)
    assert sorted(written) == list(range(K2.stash_slots(ns, n_blocks, n_lin_z)))
    assert written[:-1] == [K2.stash_slot(k, j, v, ns, n_lin_z) for k, j, v in keys]
