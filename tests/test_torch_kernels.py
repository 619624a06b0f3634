"""The port's fused serve op and its plain version against the JAX reference.

Inputs are drawn with numpy from a seed and fed to both packages. The JAX
side is ``repro.kernels.ref`` / ``repro.kernels.ops``, which on the CPU
route the fused op to the composed reference (the Pallas kernel itself
cannot trace on this JAX). Tolerance: fp32 allclose at rtol = atol = 1e-5,
the contract of tests/test_kernels.py. bf16 tables are rounded once from
the same fp32 values in both packages and summed in fp32 by both, so they
hold to the same tolerance.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import fused_serve, ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


@pytest.fixture(autouse=True)
def _one_thread():
    # intra-op threads only add contention at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, L, d, R=64, seed=0):
    """Tables at the model's init scale U(+-1/sqrt(R)), bot_out U(+-1)."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(R)
    tables = rng.uniform(-bound, bound, (T, R, d)).astype(np.float32)
    idx = rng.integers(0, R, (B, T, L)).astype(np.int32)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    return tables, idx, bot


def _both(tables, idx, bot, dtype):
    """(JAX reference output, port plain output) as numpy fp32."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_ref.fused_bag_interactions_ref(
        jnp.asarray(tables, jdt), jnp.asarray(idx), jnp.asarray(bot))
    got = ref.fused_bag_interactions_ref(
        torch.from_numpy(tables).to(dtype), torch.from_numpy(idx),
        torch.from_numpy(bot))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("B", [1, 16, 37])
def test_fused_ref_matches_jax(B, T, L, d, dtype):
    want, got = _both(*_inputs(B, T, L, d, seed=B * 1000 + T * 10 + L),
                      dtype)
    assert got.shape == (B, d + (T + 1) * T // 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_repeated_ids_count_each_time():
    tables, idx, bot = _inputs(3, 2, 4, 32)
    idx[:] = 5                                   # row 5, four times
    want, got = _both(tables, idx, bot, torch.float32)
    np.testing.assert_allclose(got, want, **TOL)
    pooled = ref.embedding_bag_ref(torch.from_numpy(tables),
                                   torch.from_numpy(idx))
    np.testing.assert_allclose(pooled[0, 1].numpy(), 4 * tables[1, 5],
                               **TOL)


def test_out_of_range_ids_follow_jnp_take():
    """A negative id counts from the end; an id outside [-R, R) gives NaN,
    as jnp.take does in the reference."""
    tables, idx, bot = _inputs(4, 2, 3, 32, R=16)
    idx[0, 0, 0] = -1
    idx[1, 1, 2] = 16
    idx[2, 0, 1] = -17
    want = np.asarray(jax_ref.embedding_bag_ref(jnp.asarray(tables),
                                                jnp.asarray(idx)))
    got = ref.embedding_bag_ref(torch.from_numpy(tables),
                                torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 1]).all() and np.isnan(got[2, 0]).all()
    np.testing.assert_allclose(got[0, 0], want[0, 0], **TOL)


def test_poisoned_row_never_read():
    """NaN in row 0 of every table, no id 0: the output stays finite."""
    tables, idx, bot = _inputs(8, 3, 4, 32)
    tables[:, 0, :] = np.nan
    idx = np.maximum(idx, 1)
    want, got = _both(tables, idx, bot, torch.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_ops_on_cpu_takes_plain_version_and_counts_nothing():
    tables, idx, bot = _inputs(16, 8, 4, 32)
    ops.reset_launch_counts()
    got = ops.fused_bag_interactions(torch.from_numpy(tables),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(bot))
    want = jax_ops.fused_bag_interactions(
        jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(bot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.launch_counts["fused_bag_interactions"] == 0
    assert all(v == 0 for v in ops.launch_counts.values())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: a CPU tensor raises
    rather than running anything."""
    tables, idx, bot = (torch.from_numpy(a) for a in _inputs(2, 2, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_serve.fused_bag_interactions(tables, idx, bot)


@pytest.mark.parametrize("name", ["ops.py", "fused_serve.py", "_build.py",
                                  "embedding_bags.py",
                                  "feature_interactions.py", "attention.py"])
def test_no_environment_switch(name):
    """The path is chosen by the tensors' device alone: the kernel layer
    reads no environment variable."""
    tree = ast.parse((KERNELS / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv"), name


def test_kernels_api_has_the_reference_ops_each_counted():
    """repro_torch.kernels exports the eight ops of repro.kernels, and
    each has a launch counter; so has ``ops.embedding_bag_blocked``, which
    the JAX package keeps in its embedding-bag module, out of
    repro.kernels."""
    import repro.kernels as jax_kernels
    import repro_torch.kernels as port_kernels

    def op_names(module):
        return {n for n in dir(module)
                if not n.startswith("_") and callable(getattr(module, n))}

    assert op_names(port_kernels) == op_names(jax_kernels)
    assert len(op_names(port_kernels)) == 8
    assert set(ops.launch_counts) == op_names(port_kernels) | {
        "embedding_bag_blocked"}
    assert "embedding_bag_blocked" not in op_names(jax_kernels)
