"""repro_torch.core.dlrm against repro.core.dlrm on the same weights.

The JAX params of ``init_dlrm`` go through numpy into
``convert.params_from_jax_numpy``; the batch is drawn with numpy.
Tolerance: fp32 allclose at rtol = atol = 1e-5 (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.core import dlrm as jax_dlrm
from repro_torch import convert
from repro_torch.configs import get_dlrm
from repro_torch.core import dlrm

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "dlrm-rm2-small-unsharded"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_dlrm(NAME).reduced()
    jparams = jax_dlrm.init_dlrm(jax.random.PRNGKey(3), jcfg)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    B = jcfg.batch_size
    dense = rng.standard_normal((B, jcfg.num_dense)).astype(np.float32)
    idx = rng.integers(0, jcfg.rows_per_table,
                       (B, jcfg.num_tables, jcfg.lookups_per_table)
                       ).astype(np.int32)
    return jcfg, jparams, params, dense, idx


def test_config_copy_matches_reference():
    for name in ("dlrm-rm2-small-unsharded", "dlrm-rm2-large-sharded"):
        for cfg, jcfg in ((get_dlrm(name), jax_get_dlrm(name)),
                          (get_dlrm(name).reduced(),
                           jax_get_dlrm(name).reduced())):
            assert cfg.__dict__ == jcfg.__dict__
            assert (cfg.bot_mlp_dims, cfg.top_mlp_in, cfg.num_interactions) \
                == (jcfg.bot_mlp_dims, jcfg.top_mlp_in, jcfg.num_interactions)


def test_converted_weights_keep_the_in_out_layout(setup):
    jcfg, jparams, params, _, _ = setup
    for key in ("bot_mlp", "top_mlp"):
        for jl, tl in zip(jparams[key], params[key]):
            assert tuple(tl["w"].shape) == jl["w"].shape       # (in, out)
            np.testing.assert_array_equal(tl["w"].numpy(), np.asarray(jl["w"]))
    assert tuple(params["tables"].shape) == jparams["tables"].shape


def test_init_matches_reference_shapes_and_bounds():
    cfg = get_dlrm(NAME).reduced()
    p = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
    jp = jax_dlrm.init_dlrm(jax.random.PRNGKey(0), jax_get_dlrm(NAME).reduced())
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), p) == shapes
    assert p["tables"].abs().max() <= np.sqrt(1.0 / cfg.rows_per_table)
    assert p["bot_mlp"][0]["w"].abs().max() <= np.sqrt(1.0 / cfg.num_dense)
    again = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["tables"], p["tables"])


def test_pieces_match_reference(setup):
    jcfg, jparams, params, dense, idx = setup
    jbot = jax_dlrm.mlp_forward(jparams["bot_mlp"], jnp.asarray(dense))
    bot = dlrm.mlp_forward(params["bot_mlp"], torch.from_numpy(dense))
    np.testing.assert_allclose(bot.numpy(), np.asarray(jbot), **TOL)
    jpooled = jax_dlrm.embedding_bag(jparams["tables"], jnp.asarray(idx))
    pooled = dlrm.embedding_bag(params["tables"], torch.from_numpy(idx))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)
    jz = jax_dlrm.feature_interactions(jbot, jpooled)
    z = dlrm.feature_interactions(bot, pooled)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)


def test_forward_predict_and_loss_match_reference(setup):
    jcfg, jparams, params, dense, idx = setup
    cfg = get_dlrm(NAME).reduced()
    jd, ji = jnp.asarray(dense), jnp.asarray(idx)
    td, ti = torch.from_numpy(dense), torch.from_numpy(idx)
    jlogits = jax_dlrm.dlrm_forward(jparams, jd, ji, jcfg)
    logits = dlrm.dlrm_forward(params, td, ti, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(
        dlrm.predict(params, td, ti, cfg).numpy(),
        np.asarray(jax_dlrm.predict(jparams, jd, ji, jcfg)), **TOL)
    labels = (np.arange(len(dense)) % 2).astype(np.float32)
    np.testing.assert_allclose(
        dlrm.bce_loss(logits, torch.from_numpy(labels)).item(),
        float(jax_dlrm.bce_loss(jlogits, jnp.asarray(labels))), **TOL)
