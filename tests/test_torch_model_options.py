"""The model options of JAX's ``model`` conf subtree, port against ``avr_tpu``.

* The decoder (``models/mlp.py ResnetFC``) against Flax ``ResnetFC`` with
  weights carried by ``load_flax_variables``: BatchNorm (``bn``, train mode
  with its running statistics, and eval mode), softplus ``beta``, SPADE,
  ``combine_type = max`` at NS 2 (at ``combine_layer`` and after the last
  block), no input (``d_in = 0``) and no latent (``z = None``).  JAX runs
  these on XLA (its ``supports`` is false), the port on its plain path.
  Where JAX fuses (``fused="always"``, the Pallas kernel in interpret
  mode), the port's module takes the K2 wrapper (its plain version on the
  CPU): the encoding-free input (``code=None``), coded view directions
  (``d_coded`` 6, ``d_pass`` 0), the depth alone (``use_xyz = False``:
  ``d_coded`` 1), no view directions (``d_pass`` 0) and a latent of 640
  lanes.
* The field (``models/pixelnerf.py PixelNeRFNet``) against Flax
  ``PixelNeRFNet`` at each option: the global encoder with ``mlp_fine {
  type = empty }``, the custom encoder, ``feature_scale`` 0.5 and 1.5,
  ``use_xyz = False``, coded view directions, ``use_code = False``,
  ``use_viewdirs = False``, ``normalize_z = False``, ``type = mlp`` (2
  layers, and 6 with the input re-injected at layer 4) and the decoder
  BatchNorm; encode and query on both, and the gradients of a loss
  of the query.  ``use_encoder = False``: JAX's ``encode`` calls an encoder
  its ``setup`` never made (it raises), so the query is held on a
  conditioning built by hand.
* The refusals: ``check_supported`` refuses JAX's three XLA-only values
  (``XLA_ONLY``) and nothing else.
* One train step of ``make_train_step`` through a few options against JAX's
  step; with ``bn`` (JAX's ``make_train_step`` renders with the batch
  statistics immutable and raises) against JAX's loss and gradients with
  the decoder's statistics mutable.

Tolerances, float32: outputs 1e-4 absolute; gradients 1e-4 of each leaf's
largest value; BatchNorm running statistics 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import parse_conf_string as jax_parse_conf
from avr_tpu.models.mlp import ResnetFC as FlaxResnetFC
from avr_tpu.models.pixelnerf import Conditioning as JaxConditioning
from avr_tpu.models.pixelnerf import ModelConfig as JaxModelConfig
from avr_tpu.models.pixelnerf import PixelNeRFNet as JaxNet
from avr_tpu.models.wrapper import RadFieldRenderer as JaxRenderer
from avr_tpu.ops.pallas.resnetfc import CodeSpec as JaxCodeSpec
from avr_tpu.renderers.base import VolumeRendererConfig as JaxVolumeConfig
from avr_tpu.renderers.base import AdaptiveRendererConfig as JaxAdaptiveConfig
from avr_tpu.training import LossParams as JaxLossParams
from avr_tpu.training import create_train_state as jax_create_state
from avr_tpu.training import make_optimizer as jax_make_optimizer
from avr_tpu.training import make_train_step as jax_make_train_step
from avr_tpu.training.loss import loss_fn as jax_loss_fn
from avr_tpu_torch.config import parse_conf_string
from avr_tpu_torch.models.flax_import import (load_flax_variables, to_flax_tree,
                                              to_flax_variables)
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.models.pixelnerf import (XLA_ONLY, Conditioning, ModelConfig, PixelNeRFNet)
from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops.kernels import _build
from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig, VolumeRendererConfig
from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                    make_train_step)
from tests.test_torch_training import KEY, _batch, _leaves
from tests.test_torch_slice import CONF_DIR, SIDE, _perturb

torch.set_num_threads(2)

TOL = 1e-4
t = lambda a: torch.from_numpy(np.array(a, np.float32))


def _close_tree(got, want, rel=TOL, what=""):
    """Leaf by leaf, ``rel`` of each leaf's largest value; a leaf whose
    gradient is zero in exact arithmetic (a bias before a train-mode
    BatchNorm) is rounding noise, held to ``rel`` of 1e-3 of the tree's
    largest value."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want)))
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        scale = max(float(np.abs(want[k]).max()), floor, 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * scale,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

# (Flax ResnetFC kwargs, NS, with z, train); d_in 8, d_latent 16, hidden 32
DECODER = {
    "bn_train": (dict(bn=True, combine_layer=2), 2, True, True),
    "bn_eval": (dict(bn=True, combine_layer=2), 2, True, False),
    "beta": (dict(beta=2.0, combine_layer=2), 2, True, False),
    "spade": (dict(use_spade=True, combine_layer=2), 2, True, False),
    "max_at_combine_layer": (dict(combine_type="max", combine_layer=2), 2, True, False),
    "max_after_last_block": (dict(combine_type="max"), 2, True, False),
    "no_input": (dict(d_in=0, combine_layer=2), 1, True, False),
    "no_latent": (dict(d_latent=0, combine_layer=2), 2, False, False),
}


def _decoder_pair(kw, ns, with_z, rng, d_hidden=32, code=None, fused="never"):
    kw = dict(dict(d_in=8, d_out=4, n_blocks=3, d_latent=16, d_hidden=d_hidden), **kw)
    if code is not None:
        kw["d_in"] = code.d_enc
    x = rng.normal(size=(2, ns, 5, code.d_raw if code else max(kw["d_in"], 1)))
    z = rng.normal(size=(2, ns, 5, kw["d_latent"])) if with_z else None
    jcode = None if code is None else JaxCodeSpec(**dataclasses.asdict(code))
    flax = FlaxResnetFC(**kw, fused=fused, code_spec=jcode, activate_out=code is not None)
    jz = None if z is None else jnp.asarray(z, jnp.float32)
    variables = flax.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32), jz, train=False)
    variables = _perturb(variables, rng)
    port = ResnetFC(kw["d_in"], 4, kw["n_blocks"], kw["d_latent"], kw["d_hidden"],
                    kw.get("combine_layer", 1000), code_spec=code,
                    activate_out=code is not None, beta=kw.get("beta", 0.0),
                    combine_type=kw.get("combine_type", "average"),
                    use_spade=kw.get("use_spade", False), bn=kw.get("bn", False))
    load_flax_variables(port, variables)
    return flax, variables, port, x.astype(np.float32), None if z is None else z.astype(np.float32)


def _decoder_run(flax, variables, port, x, z, train, w):
    """Outputs, parameter and input gradients of ``sum(out * w)``, and the
    updated statistics, on both sides."""
    stats = variables.get("batch_stats")

    def jloss(params, x_, z_):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        if train:
            out, upd = flax.apply(v, x_, z_, train=True, mutable=["batch_stats"])
        else:
            out, upd = flax.apply(v, x_, z_, train=False), {}
        return jnp.sum(out * w), (out, upd)

    jz = None if z is None else jnp.asarray(z)
    argnums = (0, 1) if z is None else (0, 1, 2)
    (_, (jout, jupd)), jg = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]), jnp.asarray(x), jz)
    tx = t(x).requires_grad_()
    tz = None if z is None else t(z).requires_grad_()
    out = port(tx, tz, train)
    loss = (out.float() * t(w)).sum()
    params = dict(port.named_parameters())
    wrt = list(params.values()) + [tx] + ([tz] if z is not None else [])
    g = torch.autograd.grad(loss, wrt, allow_unused=True)
    g = [torch.zeros_like(a) if gi is None else gi for a, gi in zip(wrt, g)]  # d_in 0: no x
    grads = to_flax_tree(dict(zip(params, g[:len(params)])))["params"]
    return dict(jout=np.asarray(jout), out=out.detach().numpy(), jg=jg, grads=grads,
                gin=[a.numpy() for a in g[len(params):]], jupd=jupd, port=port)


@pytest.mark.parametrize("case", DECODER)
def test_decoder_option_matches_flax(case):
    kw, ns, with_z, train = DECODER[case]
    rng = np.random.default_rng(7)
    flax, variables, port, x, z = _decoder_pair(kw, ns, with_z, rng)
    assert not port.fuses(ns, with_z)
    w = rng.normal(size=(2, 5, 4)).astype(np.float32)
    r = _decoder_run(flax, variables, port, x, z, train, w)
    np.testing.assert_allclose(r["out"], r["jout"], rtol=0, atol=TOL)
    _close_tree(r["grads"], r["jg"][0], what=case)
    for got, want in zip(r["gin"], r["jg"][1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-6))
    if train:
        got = _leaves(to_flax_variables(port)["batch_stats"])
        want = _leaves(r["jupd"]["batch_stats"])
        assert got.keys() == want.keys() and got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
            assert not np.array_equal(want[k], _leaves(variables["batch_stats"])[k])


# the configurations JAX fuses (d_hidden 128, ReLU, average, a latent):
# (code spec or None, d_latent, NS)
FUSED = {
    "code_none": (None, 64, 1),
    "viewdirs_coded": (CodeSpec(num_freqs=2, freq_factor=1.5, include_input=True,
                                d_coded=6, d_pass=0), 64, 2),
    "xyz_off": (CodeSpec(num_freqs=2, freq_factor=1.5, include_input=True, d_coded=1,
                         d_pass=3), 64, 1),
    "viewdirs_off": (CodeSpec(num_freqs=2, freq_factor=1.5, include_input=False, d_coded=3,
                              d_pass=0), 64, 1),
    "global_latent_640": (CodeSpec(num_freqs=2, freq_factor=1.5, include_input=True,
                                   d_coded=3, d_pass=3), 640, 1),
}


@pytest.mark.parametrize("case", FUSED)
def test_decoder_fused_route_matches_pallas(case):
    code, d_latent, ns = FUSED[case]
    rng = np.random.default_rng(11)
    kw = dict(d_in=6, d_latent=d_latent, n_blocks=2, combine_layer=1)
    flax, variables, port, x, z = _decoder_pair(kw, ns, True, rng, d_hidden=128, code=code,
                                                fused="always")
    assert port.fuses(ns, True)
    w = rng.normal(size=(2, 5, 4)).astype(np.float32)
    _build.reset_launches()
    r = _decoder_run(flax, variables, port, x, z, False, w)
    assert not _build.launches
    np.testing.assert_allclose(r["out"], r["jout"], rtol=0, atol=TOL)
    _close_tree(r["grads"], r["jg"][0], what=case)


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------

BASE = """
model {
    use_encoder = True
    use_global_encoder = False
    use_xyz = True
    use_code = True
    code { num_freqs = 2
           freq_factor = 1.5
           include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet
                 n_blocks = 2
                 d_hidden = 32
                 combine_layer = 1 }
    mlp_fine { type = resnet
               n_blocks = 2
               d_hidden = 32
               combine_layer = 1 }
    encoder { backbone = resnet18
              pretrained = False
              num_layers = 2 }
}
"""


def _conf(*edits):
    text = BASE
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    return text


# (conf edits, side, ModelConfig overrides)
FIELD = {
    "global_coarse_only": ([("use_global_encoder = False",
                             "use_global_encoder = True\n    global_encoder { backbone = resnet18\n"
                             "                     latent_size = 32 }"),
                            ("mlp_fine { type = resnet", "mlp_fine { type = empty")], 32, {}),
    "custom_encoder": ([("backbone = resnet18", "backbone = custom")], 64, {}),
    "feature_scale_half": ([("num_layers = 2", "num_layers = 2\n              feature_scale = 0.5")],
                           32, {}),
    "feature_scale_up": ([("num_layers = 2", "num_layers = 2\n              feature_scale = 1.5")],
                         32, {}),
    "xyz_off": ([("use_xyz = True", "use_xyz = False")], 32, {}),
    "viewdirs_coded": ([("use_code_viewdirs = False", "use_code_viewdirs = True")], 32, {}),
    "code_off": ([("use_code = True", "use_code = False")], 32, {}),
    "viewdirs_off": ([("use_viewdirs = True", "use_viewdirs = False")], 32, {}),
    "normalize_z_off": ([("use_xyz = True", "use_xyz = True\n    normalize_z = False")], 32, {}),
    "type_mlp": ([("mlp_fine { type = resnet", "mlp_fine { type = mlp"),
                  ("use_global_encoder = False",
                   "use_global_encoder = True\n    global_encoder { backbone = resnet18\n"
                   "                     latent_size = 16 }")], 32, {}),
    # 6 layers: the input re-injected at layer 4 (JAX's default skip_in);
    # the coarse pools after its last layer, the fine before the skip
    "type_mlp_skip": ([("mlp_coarse { type = resnet\n                 n_blocks = 2\n"
                        "                 d_hidden = 32\n                 combine_layer = 1 }",
                        "mlp_coarse { type = mlp\n n_blocks = 6\n d_hidden = 32 }"),
                       ("mlp_fine { type = resnet\n               n_blocks = 2\n"
                        "               d_hidden = 32\n               combine_layer = 1 }",
                        "mlp_fine { type = mlp\n n_blocks = 6\n d_hidden = 32\n"
                        " combine_layer = 3 }")], 32, {}),
    "spade_beta_max": ([("mlp_coarse { type = resnet", "mlp_coarse { type = resnet\n"
                         "                 use_spade = True\n                 beta = 1.5\n"
                         "                 combine_type = max")], 32, {}),
    "bn_decoder": ([], 32, {"bn": True}),
}


def _nets(case, rng, ns=2):
    edits, side, over = FIELD[case]
    text = _conf(*edits)
    jcfg = JaxModelConfig.from_conf(jax_parse_conf(text)["model"], **over)
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder,
                                                                 norm_type="group"))
    jnet = JaxNet(cfg=jcfg)
    images = rng.uniform(-1, 1, size=(1, ns, side, side, 3)).astype(np.float32)
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    poses = np.broadcast_to(c2w, (1, ns, 4, 4)).copy()
    poses[0, -1, 0, 3] = 0.1  # the views differ
    focal = np.float32(1.09375 * side)
    c = np.asarray([side / 2, side / 2], np.float32)
    enc_in = (jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c))
    variables = _perturb(jnet.init(jax.random.PRNGKey(0), *enc_in, method=jnet.init_all), rng)
    cfg = ModelConfig.from_conf(parse_conf_string(text)["model"], **over)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, norm_type="group"))
    port = load_flax_variables(PixelNeRFNet(cfg), variables)
    xyz = rng.normal(scale=0.3, size=(1, 9, 3)).astype(np.float32)
    vd = rng.normal(size=(1, 9, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return jnet, variables, port, (images, poses, focal, c), xyz, vd


def _query_fn(coarse, train):
    def fn(mdl, images, poses, focal, c, xyz, vd):
        cond = mdl.encode(images, poses, focal, c, train=train)
        return mdl(cond, xyz, vd, coarse=coarse, train=train), cond

    return fn


@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("case", FIELD)
def test_field_option_matches_flax(case, coarse):
    rng = np.random.default_rng(5)
    jnet, variables, port, (images, poses, focal, c), xyz, vd = _nets(case, rng)
    train = case == "bn_decoder"
    w = rng.normal(size=(1, 9, 4)).astype(np.float32)
    stats = variables.get("batch_stats", {})
    fn = _query_fn(coarse, train)

    def jloss(params):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        args = (jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
                jnp.asarray(xyz), jnp.asarray(vd))
        if train:
            (out, cond), upd = jnet.apply(v, *args, method=fn, mutable=["batch_stats"])
        else:
            (out, cond), upd = jnet.apply(v, *args, method=fn), {}
        return jnp.sum(out * w), (out, cond, upd)

    (_, (jout, jcond, jupd)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))

    cond = port.encode(t(images), t(poses), float(focal), t(c), train=train)
    out = port(cond, t(xyz), t(vd), coarse=coarse, train=train)
    np.testing.assert_allclose(cond.latent.detach().numpy(), np.asarray(jcond.latent),
                               rtol=0, atol=TOL)
    if jcond.global_latent is not None:
        np.testing.assert_allclose(cond.global_latent.detach().numpy(),
                                   np.asarray(jcond.global_latent), rtol=0, atol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=TOL)
    params = dict(port.named_parameters())
    g = torch.autograd.grad((out * t(w)).sum(), list(params.values()), allow_unused=True)
    grads = {n: (gi if gi is not None else torch.zeros_like(p))
             for (n, p), gi in zip(params.items(), g)}
    _close_tree(to_flax_tree(grads)["params"], jg, what=case)
    if train:
        got = _leaves(to_flax_variables(port)["batch_stats"])
        want = _leaves(jupd["batch_stats"])
        dec = [k for k in want if "bn_0" in k and ("mlp_coarse" if coarse else "mlp_fine") in k]
        assert dec
        for k in dec:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_field_without_encoder_matches_flax():
    """``use_encoder = False`` with the global latent: JAX's ``encode`` raises
    (no encoder), so both query a conditioning built by hand."""
    rng = np.random.default_rng(9)
    text = _conf(("use_encoder = True", "use_encoder = False"),
                 ("use_global_encoder = False", "use_global_encoder = True"))
    jnet = JaxNet(cfg=JaxModelConfig.from_conf(jax_parse_conf(text)["model"]))
    cfg = ModelConfig.from_conf(parse_conf_string(text)["model"])
    assert cfg.d_latent == 128
    glob = rng.normal(size=(2, 128)).astype(np.float32)
    w2c = np.concatenate([np.eye(3), [[0.0], [0.0], [1.3]]], -1).astype(np.float32)
    w2c = np.broadcast_to(w2c, (2, 3, 4)).copy()
    focal = np.asarray([[35.0, -35.0]], np.float32)
    cc = np.asarray([[16.0, 16.0]], np.float32)
    shape = np.asarray([32.0, 32.0], np.float32)
    jcond = JaxConditioning(latent=None, latent_scaling=jnp.ones(2), poses=jnp.asarray(w2c),
                            focal=jnp.asarray(focal), c=jnp.asarray(cc),
                            image_shape=jnp.asarray(shape), global_latent=jnp.asarray(glob),
                            num_views=2)
    xyz = rng.normal(scale=0.3, size=(1, 7, 3)).astype(np.float32)
    vd = rng.normal(size=(1, 7, 3)).astype(np.float32)
    both = jnet.init(jax.random.PRNGKey(0), jcond, jnp.asarray(xyz), jnp.asarray(vd),
                     method=lambda m, *a: (m(*a), m(*a, coarse=False)))
    variables = _perturb(both, rng)
    port = PixelNeRFNet(cfg)
    assert not hasattr(port, "encoder")
    for head in ("mlp_coarse", "mlp_fine"):  # the query's parameters
        load_flax_variables(getattr(port, head), {"params": variables["params"][head]})
    cond = Conditioning(None, torch.ones(2), t(w2c), t(focal), t(cc), t(shape), 2, t(glob))
    for coarse in (True, False):
        want = jnet.apply(variables, jcond, jnp.asarray(xyz), jnp.asarray(vd), coarse=coarse)
        got = port(cond, t(xyz), t(vd), coarse=coarse)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    # the port's encode runs without the spatial encoder
    enc = port.encode(torch.zeros(1, 2, 32, 32, 3), t(np.eye(4)[None, None].repeat(2, 1)), 35.0)
    assert enc.latent is None and enc.global_latent.shape == (2, 128)


def test_check_supported_refuses_only_xla_paths():
    assert XLA_ONLY == {"fused_mlp": "never", "fused_march": "never", "gather_impl": "xla"}
    for key, value in XLA_ONLY.items():
        with pytest.raises(NotImplementedError, match="one implementation"):
            if key == "fused_march":  # the march's flag, not a field of the config
                ModelConfig().check_supported(fused_march=value)
            else:
                ModelConfig(**{key: value}).check_supported()
    text = _conf(*FIELD["spade_beta_max"][0], ("backbone = resnet18", "backbone = custom"),
                 ("mlp_fine { type = resnet", "mlp_fine { type = mlp"),
                 ("use_global_encoder = False", "use_global_encoder = True"),
                 ("use_xyz = True", "use_xyz = False\n    normalize_z = False"),
                 ("use_code_viewdirs = False", "use_code_viewdirs = True"))
    ModelConfig.from_conf(parse_conf_string(text)["model"], bn=True).check_supported()


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

STEP_CONF = """
include required("default_mv.conf")
model {
    encoder { num_layers = 2 }
    mlp_coarse { d_hidden = 128
                 n_blocks = 2
                 combine_layer = 1 }
    mlp_fine { d_hidden = 128
               n_blocks = 2
               combine_layer = 1 }
}
adaptive_renderer { raymarch_steps = 3
                    n_coarse = 4 }
normal_renderer { n_coarse = 8
                  n_fine = 4
                  n_fine_depth = 2 }
"""

# (model edits, renderer): the VR for the decoder-only options
STEP = {
    "global_coarse_only": ([("mlp_fine { d_hidden = 128", "mlp_fine { type = empty\n d_hidden = 128"),
                            ("model {", "model {\n    use_global_encoder = True\n"
                             "    global_encoder { backbone = resnet18\n latent_size = 64 }")],
                           "VR"),
    "custom_type_mlp": ([("encoder { num_layers = 2 }", "encoder { backbone = custom }"),
                         ("mlp_fine { d_hidden = 128", "mlp_fine { type = mlp\n d_hidden = 32")],
                        "adaptive"),
    "type_mlp_skip": ([("mlp_coarse { d_hidden = 128\n                 n_blocks = 2",
                        "mlp_coarse { type = mlp\n d_hidden = 32\n n_blocks = 6"),
                       ("mlp_fine { d_hidden = 128\n               n_blocks = 2",
                        "mlp_fine { type = mlp\n d_hidden = 32\n n_blocks = 5")], "VR"),
    "xyz_off_code_off": ([("model {", "model {\n    use_xyz = False\n    use_code = False")],
                         "VR"),
}


def _step_models(edits, renderer, bn=False, side=SIDE):
    text = STEP_CONF
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new, 1)
    jconf = jax_parse_conf(text, base_dir=CONF_DIR)
    jcfg = JaxModelConfig.from_conf(jconf["model"], bn=bn)
    jren = (JaxVolumeConfig.from_conf(jconf["normal_renderer"]) if renderer == "VR"
            else JaxAdaptiveConfig.from_conf(jconf["adaptive_renderer"]))
    jmodel = JaxRenderer(model_cfg=jcfg, renderer_cfg=jren)
    conf = parse_conf_string(text, base_dir=CONF_DIR)
    ren = (VolumeRendererConfig.from_conf(conf["normal_renderer"]) if renderer == "VR"
           else AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]))
    port = RadFieldRenderer(ModelConfig.from_conf(conf["model"], bn=bn), ren)
    return jmodel, port


def _batch64():
    """``test_torch_training.py``'s batch with 64 x 64 source views: the
    global encoder's train-mode BatchNorm over a 32 x 32 view's 1 x 1 last
    stage normalises 2 values a channel, and amplifies rounding past any
    tolerance."""
    images, poses, focal, c, model_input, gt = _batch()
    rng = np.random.default_rng(22)
    images = rng.uniform(-1, 1, size=(images.shape[0], 1, 2 * SIDE, 2 * SIDE, 3))
    return (images.astype(np.float32), poses, np.float32(2 * focal),
            np.asarray([SIDE, SIDE], np.float32), model_input, gt)


def _stepped(edits, renderer, bn=False):
    rng = np.random.default_rng(0)
    jmodel, port = _step_models(edits, renderer, bn)
    glob = any("use_global_encoder" in new for _, new in edits)
    images, poses, focal, c, model_input, gt = _batch64() if glob else _batch()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                            jnp.asarray(poses[:1]), focal, jnp.asarray(c),
                            method=jmodel.init_all)
    variables = _perturb(variables, rng)
    load_flax_variables(port, variables)
    opt = make_optimizer(1e-4)
    state = create_train_state(port, opt)
    step = make_train_step(port, opt, LossParams(loss_mode="both"), rng_mode="legacy")
    _build.reset_launches()
    state, metrics = step(state, t(images), t(poses), float(focal), t(c),
                          {k: t(v) for k, v in model_input.items()}, t(gt), (0, KEY))
    assert not _build.launches
    jin = (jnp.asarray(images), jnp.asarray(poses), focal, jnp.asarray(c),
           jax.tree.map(jnp.asarray, model_input), jnp.asarray(gt))
    return jmodel, variables, jin, port, state, metrics


@pytest.mark.parametrize("case", STEP)
def test_train_step_through_options_matches_jax(case):
    jmodel, variables, jin, port, state, metrics = _stepped(*STEP[case])
    tx = jax_make_optimizer(1e-4)
    jstate = jax_create_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jax_make_train_step(jmodel, tx, JaxLossParams(loss_mode="both"), donate=False,
                                rng_mode="legacy")
    jstate, jm = jstep(jstate, *jin, jax.random.PRNGKey(KEY))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=0, atol=1e-5)
    mu = to_flax_tree(state.opt_state.mu)["params"]
    # Adam's first moment after one step is 0.1 g; the adaptive march's
    # chaotic recurrence (test_torch_training.py) takes 5e-3 of scale
    rel = 5e-3 if STEP[case][1] == "adaptive" else TOL
    _close_tree(mu, jstate.opt_state.inner_state[0].mu, rel=rel, what=case)


def test_train_step_decoder_batchnorm_matches_jax_loss():
    """``bn``: the port's step against JAX's loss and gradients with the
    decoders' statistics mutable in the render (JAX's ``make_train_step``
    renders with them immutable and raises), and the statistics after it."""
    jmodel, variables, jin, port, state, metrics = _stepped(STEP["xyz_off_code_off"][0], "VR",
                                                            bn=True)
    images, poses, focal, c, model_input, gt = jin
    stats = variables["batch_stats"]

    def loss(params):
        cond, s1 = jmodel.apply({"params": params, "batch_stats": stats}, images, poses,
                                focal, c, train=True, method=jmodel.encode,
                                mutable=["batch_stats"])
        out, s2 = jmodel.apply({"params": params, "batch_stats": s1["batch_stats"]}, cond,
                               model_input["x_pix"], model_input["intrinsics"],
                               model_input["cam2world"], jax.random.PRNGKey(KEY), train=True,
                               method=jmodel.render, mutable=["batch_stats"])
        return jax_loss_fn(out, gt, JaxLossParams(loss_mode="both")), s2

    # jitted as JAX's step is (op by op, JAX's VR gradients of the encoder
    # move by up to 18% of a leaf's scale against its own jitted step's)
    (jl, upd), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=0, atol=1e-5)
    mu = to_flax_tree(state.opt_state.mu)["params"]
    _close_tree(mu, jax.tree.map(lambda g: 0.1 * g, jg), what="bn")
    got = _leaves(to_flax_variables(port)["batch_stats"])
    want = _leaves(upd["batch_stats"])
    assert got.keys() == want.keys() and any("bn_0" in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
