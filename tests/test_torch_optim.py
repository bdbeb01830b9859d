"""The ported optimizer against the JAX package (omnivggt_tpu.train.optim):
the weight-decay mask and layer-decay scale of every parameter, and 3 steps
of make_optimizer / make_finetune_optimizer on the same gradients (atol
1e-6: float32 rounding of the two AdamW formulations). The same weights on
both sides (tests/torch_port_util.tiny_pair).
"""

import numpy as np
import pytest
import torch

import jax
import optax

from omnivggt_tpu import config as JC
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.train import optim as JO
from omnivggt_tpu.train import step as JS
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import params_from_jax
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.train import optim as TO
from omnivggt_tpu_torch.train import step as TS
from tests.torch_port_util import tiny_pair, to_np

def test_weight_decay_mask_and_layer_decay_match_jax():
    """Per parameter, against weight_decay_mask / scale_by_layer_decay, on
    a config with a DINOv2 backbone: its blocks decay over their own depth,
    the rest of patch_embed by decay^(deepest stack), depth_patch_embed
    not at all."""
    kw = dict(embed_dim=384, num_heads=6, depth=2, patch_embed="dinov2_vits14_reg")
    jcfg, tcfg = JC.tiny_test_config(**kw), TC.tiny_test_config(**kw)
    # the rules read names and shapes only: zeros shaped like the params
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                          jax.eval_shape(lambda key: JM.init(key, jcfg), jax.random.PRNGKey(0)))
    model = TM.OmniVGGT(tcfg, device="cpu", seed=None)
    mask = params_from_jax(
        jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), JO.weight_decay_mask(params),
                     params),
        tcfg,
    )
    ld = JO.scale_by_layer_decay(params, layer_decay=0.5)
    ones = jax.tree.map(np.ones_like, params)
    scales = params_from_jax(to_np(jax.jit(ld.update)(ones, ld.init(params))[0]), tcfg)
    port_mask = TO.weight_decay_mask(model)
    port_scales = TO.layer_decay_scales(model, 0.5)
    assert port_mask.keys() == mask.keys() == port_scales.keys()
    for name in mask:
        assert torch.all(mask[name] == float(port_mask[name])), name
        np.testing.assert_allclose(scales[name].numpy(), port_scales[name], rtol=1e-6, err_msg=name)
    assert port_scales["aggregator.patch_embed.blocks.0.attn.qkv.weight"] == 0.5**11
    assert port_scales["aggregator.patch_embed.pos_embed"] == 0.5**12
    assert port_scales["aggregator.depth_patch_embed.proj.weight"] == 1.0


@pytest.mark.parametrize("kind", ["finetune", "plain"])
def test_optimizer_matches_optax(kind):
    """3 steps (warmup 1) on the same parameters and gradients: the port's
    parameters equal params_from_jax of optax's within 1e-6, and the
    reported norms are optax.global_norm before clipping. Step sizes mix
    gradients under and over the clip norm."""
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    rng = np.random.default_rng(3)
    grads = [
        jax.tree.map(lambda p: (rng.normal(size=p.shape) * s).astype(np.float32), params)
        for s in (0.05, 0.001, 0.03)
    ]
    hp = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    if kind == "finetune":
        opt_j = JO.make_finetune_optimizer(params, layer_decay=0.8, **hp)
        opt_t = TO.make_finetune_optimizer(model, layer_decay=0.8, **hp)
    else:
        opt_j, opt_t = JS.make_optimizer(**hp), TS.make_optimizer(model, **hp)
    p_j, state_j = params, opt_j.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *opt_j.update(g, s, p)))
    named = dict(model.named_parameters())
    for g in grads:
        p_j, state_j = update(g, state_j, p_j)
        for name, grad in params_from_jax(g, tcfg).items():
            named[name].grad = grad
        norm = opt_t.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
    want = params_from_jax(to_np(p_j), tcfg)
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


