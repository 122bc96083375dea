"""The port's weight importers (``avr_tpu_torch/models/torch_import.py``)
against the JAX package's (``avr_tpu/models/torch_import.py``).

On seeded synthetic torch state dicts (numpy arrays with torch's names and
layouts), each port importer loaded with ``load_state_dict(strict=True)``
gives the port module the same tensors, bit for bit, as JAX's importer
followed by ``load_flax_variables``: a torchvision ResNet (resnet18 and
resnet34, 2 to 4 layers, BatchNorm statistics included) into the encoder's
trunk, ``nn.LSTMCell`` into ``MarchLSTMCell`` and the reference ``ResnetFC``
into the decoder.  An archive of another encoder (a stage short, another
width) and a decoder with a projection shortcut (which the port's blocks do
not have) raise.

(``tests/test_torch_import.py`` is a JAX test of JAX's importer, despite
its name.)
"""

import numpy as np
import pytest
import torch

from avr_tpu.models import torch_import as jax_import
from avr_tpu_torch.models import torch_import
from avr_tpu_torch.models.flax_import import load_flax_variables
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.models.resnet import RESNET_STAGES, ResNetTrunk
from avr_tpu_torch.renderers.lstm import MarchLSTMCell
from tests.test_torch_cli import torchvision_archive

torch.set_num_threads(2)


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("backbone, num_layers", [("resnet18", 2), ("resnet18", 4),
                                                  ("resnet34", 3)])
def test_torchvision_resnet_matches_jax(tmp_path, backbone, num_layers):
    sd = torchvision_archive(tmp_path / "tv.npz", backbone, num_layers, seed=num_layers)
    bps = RESNET_STAGES[backbone][0]
    want = ResNetTrunk(backbone, num_layers)
    load_flax_variables(want, jax_import.import_torchvision_resnet(
        sd, blocks_per_stage=bps, num_layers=num_layers))
    got = ResNetTrunk(backbone, num_layers)
    got.load_state_dict(torch_import.import_torchvision_resnet(sd, bps, num_layers))
    _assert_same(_state(got), _state(want))
    assert torch.equal(got.conv1.weight, torch.from_numpy(sd["conv1.weight"]))


def test_another_encoder_raises(tmp_path):
    sd18 = torchvision_archive(tmp_path / "r18.npz", "resnet18", 3)
    with pytest.raises(KeyError):  # resnet34's layer1 has a third block
        torch_import.import_torchvision_resnet(sd18, RESNET_STAGES["resnet34"][0], 3)
    narrow = dict(sd18, **{"layer2.0.conv1.weight": sd18["layer2.0.conv1.weight"][:64]})
    with pytest.raises(RuntimeError, match="size mismatch"):
        ResNetTrunk("resnet18", 3).load_state_dict(
            torch_import.import_torchvision_resnet(narrow, (2, 2, 2, 2), 3))


def _lstm_sd(rng, d, h, prefix="lstm"):
    return {f"{prefix}.weight_ih": rng.standard_normal((4 * h, d)).astype(np.float32),
            f"{prefix}.weight_hh": rng.standard_normal((4 * h, h)).astype(np.float32),
            f"{prefix}.bias_ih": rng.standard_normal(4 * h).astype(np.float32),
            f"{prefix}.bias_hh": rng.standard_normal(4 * h).astype(np.float32)}


@pytest.mark.parametrize("d, h, prefix", [(512, 16, "lstm"), (128, 8, "renderer.lstm")])
def test_lstm_cell_matches_jax(d, h, prefix):
    sd = _lstm_sd(np.random.default_rng(d + h), d, h, prefix)
    want = MarchLSTMCell(d, h)
    load_flax_variables(want, {"params": jax_import.import_lstm_cell(sd, prefix)})
    got = MarchLSTMCell(d, h)
    got.load_state_dict(torch_import.import_lstm_cell(sd, prefix))
    _assert_same(_state(got), _state(want))
    # torch's (4H, D) gates, transposed to the cell's (D, 4H)
    assert torch.equal(got.w_ih, torch.from_numpy(sd[f"{prefix}.weight_ih"]).T)


def _resnetfc_sd(rng, prefix, d_in, d_out, d_latent, d_hidden, n_blocks, n_lin_z,
                 shortcut=False):
    sd = {}

    def lin(name, i, o):
        sd[f"{prefix}.{name}.weight"] = rng.standard_normal((o, i)).astype(np.float32)
        sd[f"{prefix}.{name}.bias"] = rng.standard_normal(o).astype(np.float32)

    lin("lin_in", d_in, d_hidden)
    lin("lin_out", d_hidden, d_out)
    for i in range(n_blocks):
        lin(f"blocks.{i}.fc_0", d_hidden, d_hidden)
        lin(f"blocks.{i}.fc_1", d_hidden, d_hidden)
        if shortcut:
            sd[f"{prefix}.blocks.{i}.shortcut.weight"] = rng.standard_normal(
                (d_hidden, d_hidden)).astype(np.float32)
    for i in range(n_lin_z):
        lin(f"lin_z.{i}", d_latent, d_hidden)
    return sd


@pytest.mark.parametrize("n_blocks, combine_layer", [(5, 3), (2, 1)])
def test_resnetfc_matches_jax(n_blocks, combine_layer):
    d_in, d_latent, d_hidden = 42, 64, 32
    n_lin_z = min(combine_layer, n_blocks)
    sd = _resnetfc_sd(np.random.default_rng(n_blocks), "mlp_coarse", d_in, 4, d_latent,
                      d_hidden, n_blocks, n_lin_z)
    make = lambda: ResnetFC(d_in, 4, n_blocks, d_latent, d_hidden, combine_layer)
    want = make()
    load_flax_variables(want, {"params": jax_import.import_resnetfc(sd, "mlp_coarse", n_blocks,
                                                                    n_lin_z)})
    got = make()
    got.load_state_dict(torch_import.import_resnetfc(sd, "mlp_coarse", n_blocks, n_lin_z))
    _assert_same(_state(got), _state(want))


def test_resnetfc_with_a_shortcut_raises():
    sd = _resnetfc_sd(np.random.default_rng(0), "mlp", 42, 4, 64, 32, 2, 1, shortcut=True)
    imported = torch_import.import_resnetfc(sd, "mlp", 2, 1)
    assert "blocks.0.shortcut.weight" in imported
    with pytest.raises(RuntimeError, match="shortcut"):
        ResnetFC(42, 4, 2, 64, 32, 1).load_state_dict(imported)
