"""State-space / linear-attention mixers: Mamba (jamba) and RWKV6 (finch).

As the reference (``repro.models.ssm``), each has two modes that share
parameters:

  * ``*_scan`` : full-sequence mode for train / prefill: a loop over time
    carries the recurrent state (chunked and rematerialized under
    autograd, ``chunked_time_scan``). O(T) compute, O(1) state.
  * ``*_step`` : single-token decode; takes and returns the state
    explicitly, as the attention cache does.

State layouts (the reference's, so ``convert.params_from_jax_numpy``
carries them unchanged):
  mamba : {"conv": (B, d_conv-1, d_inner), "ssm": (B, d_inner, d_state)}
  rwkv6 : {"wkv": (B, H, hd, hd), "x_prev": (B, d_model)}
``conv`` and ``x_prev`` take the compute dtype, ``ssm`` and ``wkv`` stay
fp32.

No TPU kernel corresponds to these mixers: the reference runs them in jnp
and ``lax.scan``, the port in plain torch. The time loop is a Python loop
whose every op is a launch, so each step is written with few ops: the
inputs of all steps are projected, cast and laid out time-major in bulk
before the loop (ROADMAP S12 would fuse the loop into one kernel).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init

SSM_CHUNK = 64  # time steps a rematerialized chunk covers (0: no chunking)

State = Dict[str, torch.Tensor]


def _scan(step_fn: Callable, prepare: Callable, state: torch.Tensor,
          xs: Tuple[torch.Tensor, ...]):
    """``step_fn(state, *per_step) -> (state, y_t)`` over the steps of
    ``prepare(*xs)`` (tensors with a leading time dim, each unbound once:
    one autograd node, not one a step); returns (state, the y_t stacked
    (T, ...))."""
    ys = []
    for inp in zip(*(x.unbind(0) for x in prepare(*xs))):
        state, y = step_fn(state, *inp)
        ys.append(y)
    return state, torch.stack(ys)


def chunked_time_scan(step_fn: Callable, state: torch.Tensor,
                      xs: Tuple[torch.Tensor, ...], chunk: int = SSM_CHUNK,
                      prepare: Callable = lambda *xs: xs):
    """scan(step_fn) over the leading (time) dim of ``xs``, rematerialized a
    chunk at a time while autograd records; ``prepare`` turns a chunk of
    ``xs`` into the steps' inputs in bulk (so a step runs few ops).

    Without it autograd saves every step's state; each chunk under
    ``torch.utils.checkpoint`` keeps only its boundary state and recomputes
    ``prepare`` and its steps in the backward (the reference's
    ``jax.checkpoint`` on the chunk body). The reference's rule for when to
    chunk: not when ``chunk <= 1``, ``T <= chunk`` or ``T % chunk != 0``.
    Without autograd the chunks run the same ops on the same values, only
    with ``prepare``'s tensors a chunk long. Returns (state, ys (T,
    ...))."""
    T = xs[0].shape[0]
    if chunk <= 1 or T <= chunk or T % chunk != 0:
        return _scan(step_fn, prepare, state, xs)
    ys = []
    for c0 in range(0, T, chunk):
        part = tuple(x[c0:c0 + chunk] for x in xs)
        if torch.is_grad_enabled():
            state, y = checkpoint(_scan, step_fn, prepare, state, part,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            state, y = _scan(step_fn, prepare, state, part)
        ys.append(y)
    return state, torch.cat(ys)


def _time_major(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """(B, T, ...) reshaped to ``shape`` -> (T, B, ...) fp32, contiguous, so
    each step reads one contiguous slice."""
    return x.reshape(shape).transpose(0, 1).float().contiguous()


# ---------------------------------------------------------------------------
# Mamba (S6): selective state space, jamba's non-attention mixer
# ---------------------------------------------------------------------------
def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The reference's params (``lead`` stacks that many layers): S4D-real
    ``a_log``, ``dt_bias`` the inverse softplus of dt ~ logU(1e-3, 0.1)."""
    assert cfg.ssm is not None and cfg.ssm.kind == "mamba"
    d = cfg.d_model
    di = cfg.ssm.expand * d
    ds = cfg.ssm.d_state
    dc = cfg.ssm.d_conv
    dt_rank = max(1, math.ceil(d / 16))
    dev, lead = generator.device, tuple(lead)

    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        lead + (di, ds))
    u = torch.rand(lead + (di,), generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "w_in": dense_init(generator, d, 2 * di, lead=lead),  # x and gate z
        "conv_w": dense_init(generator, dc, di, lead=lead),   # N(0, 1/dc)
        "conv_b": torch.zeros(lead + (di,), device=dev),
        "w_x": dense_init(generator, di, dt_rank + 2 * ds, lead=lead),
        "w_dt": dense_init(generator, dt_rank, di, lead=lead),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(a),
        "d_skip": torch.ones(lead + (di,), device=dev),
        "w_out": dense_init(generator, di, d,
                            scale=1.0 / math.sqrt(2 * cfg.n_layers),
                            lead=lead),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no linear
    branch (``F.softplus`` switches to x above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _mamba_prepare(a: torch.Tensor, dt: torch.Tensor, dtx: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor):
    """A chunk's discretization in bulk: dA = exp(dt A), dBx = (dt x) B
    (n, B, di, ds), and C as columns (n, B, ds, 1); dt, dtx (n, B, di), b,
    c (n, B, ds), a (di, ds)."""
    return (torch.exp(dt.unsqueeze(-1) * a),
            dtx.unsqueeze(-1) * b.unsqueeze(-2), c.unsqueeze(-1))


def _mamba_step(h: torch.Tensor, da: torch.Tensor, dbx: torch.Tensor,
                c_col: torch.Tensor):
    """One step: h = h * dA + dBx; y = h C. h (B, di, ds); returns y as
    (B, di, 1)."""
    h = torch.addcmul(dbx, h, da)
    return h, torch.bmm(h, c_col)


def _mamba_inner(p: Dict[str, torch.Tensor], xz: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 chunk: int = SSM_CHUNK):
    """Shared scan body. xz: (B, T, 2*di), the input projection.
    conv_state: (B, d_conv-1, di), ssm_state: (B, di, ds). Returns
    (y (B, T, di) gated, conv_state', ssm_state')."""
    B, T, _ = xz.shape
    di = p["d_skip"].shape[0]
    ds = p["a_log"].shape[1]
    dt_rank = p["w_dt"].shape[0]
    dc = p["conv_w"].shape[0]
    x, z = xz.chunk(2, dim=-1)                              # (B, T, di)
    dtype = x.dtype

    # depthwise causal conv over the carried last dc-1 inputs
    x_ext = torch.cat([conv_state.to(dtype), x], dim=1)     # (B, T+dc-1, di)
    new_conv_state = x_ext[:, -(dc - 1):] if dc > 1 else conv_state
    xc = x_ext[:, 0:T] * p["conv_w"][0].to(dtype)
    for i in range(1, dc):
        xc = xc + x_ext[:, i:i + T] * p["conv_w"][i].to(dtype)
    xc = F.silu(xc + p["conv_b"].to(dtype))

    proj = xc @ p["w_x"].to(dtype)                          # (B, T, r+2ds)
    dt_low, b_t, c_t = proj.split([dt_rank, ds, ds], dim=-1)
    dt = _softplus(dt_low @ p["w_dt"].to(dtype) + p["dt_bias"].to(dtype))

    a = -torch.exp(p["a_log"])                              # (di, ds) fp32
    dt32 = _time_major(dt, (B, T, di))
    xc32 = xc.float()
    dtx32 = dt32 * _time_major(xc32, (B, T, di))
    h_last, ys = chunked_time_scan(
        _mamba_step, ssm_state.float(),
        (dt32, dtx32, _time_major(b_t, (B, T, ds)),
         _time_major(c_t, (B, T, ds))), chunk,
        prepare=functools.partial(_mamba_prepare, a))
    y = ys.squeeze(-1).transpose(0, 1) + xc32 * p["d_skip"]  # (B, T, di)
    # the gate in fp32, rounded once: XLA drops the reference's round trip
    # through the compute dtype here, and rounding y, silu(z) and their
    # product apart leaves jamba's bf16 grads ~2.3x further from fp32's
    y = (y * F.silu(z.float())).to(dtype)
    return (y, new_conv_state.to(conv_state.dtype),
            h_last.to(ssm_state.dtype))


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead: Tuple[int, ...] = ()) -> State:
    di = cfg.ssm.expand * cfg.d_model
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm.d_conv - 1, di),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, di, cfg.ssm.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_scan(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, state: Optional[State] = None,
               chunk: int = SSM_CHUNK) -> Tuple[torch.Tensor, State]:
    """Full-sequence mamba mixer. x: (B, T, d) -> (B, T, d), final state."""
    if state is None:
        state = init_mamba_state(cfg, x.shape[0], x.dtype, x.device)
    xz = x @ p["w_in"].to(x.dtype)
    y, conv_s, ssm_s = _mamba_inner(p, xz, state["conv"], state["ssm"],
                                    chunk)
    return y @ p["w_out"].to(x.dtype), {"conv": conv_s, "ssm": ssm_s}


def mamba_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, state: State) -> Tuple[torch.Tensor, State]:
    """Single-token decode step. x: (B, 1, d)."""
    return mamba_scan(p, x, cfg, state)


# ---------------------------------------------------------------------------
# RWKV6 "Finch": data-dependent decay linear attention
# ---------------------------------------------------------------------------
def init_rwkv6(generator: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Time-mix params (``lead`` stacks that many layers); heads of
    ``ssm.head_dim`` over d_model."""
    assert cfg.ssm is not None and cfg.ssm.kind == "rwkv6"
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    assert d % hd == 0
    dev, lead = generator.device, tuple(lead)
    lora = max(32, d // 16)  # decay LoRA rank

    def full(value):
        return torch.full(lead + (d,), value, dtype=torch.float32,
                          device=dev)

    p = {f"mix_{n}": full(0.5) for n in "rkvgw"}
    for n in "rkvg":
        p[f"w_{n}"] = dense_init(generator, d, d, lead=lead)
    p["w_o"] = dense_init(generator, d, d,
                          scale=1.0 / math.sqrt(2 * cfg.n_layers), lead=lead)
    # data-dependent decay: w = exp(-exp(decay_base + lora(x)))
    p["decay_base"] = full(-6.0)
    p["w_decay_a"] = dense_init(generator, d, lora, scale=0.1, lead=lead)
    p["w_decay_b"] = dense_init(generator, lora, d, scale=0.1, lead=lead)
    p["bonus"] = torch.empty(lead + (d // hd, hd), device=dev).normal_(
        0.0, 0.05, generator=generator)                       # u, per head
    p["ln_w"] = full(1.0)   # per-head group norm
    p["ln_b"] = full(0.0)
    return p


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead: Tuple[int, ...] = ()) -> State:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    lead = tuple(lead)
    return {
        "wkv": torch.zeros(lead + (batch, d // hd, hd, hd),
                           dtype=torch.float32, device=device),
        "x_prev": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
    }


def _rwkv_group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     H: int) -> torch.Tensor:
    """Per-head layer norm on (B, T, d) viewed as (B, T, H, hd): fp32, the
    population variance (``jnp.var``), back in ``x.dtype``."""
    B, T, d = x.shape
    xh = x.reshape(B, T, H, d // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, T, d) * w + b).to(x.dtype)


def _rwkv_step(s: torch.Tensor, r_row: torch.Tensor, k_col: torch.Tensor,
               v_row: torch.Tensor, w_col: torch.Tensor):
    """One step over batch x heads: y = r s; s = s w + k v^T. s (BH, hd,
    hd); r_row, v_row (BH, 1, hd); k_col, w_col (BH, hd, 1). The current
    token's bonus term r (u k v^T) is added outside the loop."""
    y = torch.bmm(r_row, s)
    return torch.addcmul(torch.bmm(k_col, v_row), s, w_col), y


def rwkv6_scan(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, state: Optional[State] = None,
               chunk: int = SSM_CHUNK) -> Tuple[torch.Tensor, State]:
    """RWKV6 time-mix over a full sequence. x: (B, T, d)."""
    B, T, d = x.shape
    hd = cfg.ssm.head_dim
    H = d // hd
    dtype = x.dtype
    if state is None:
        state = init_rwkv6_state(cfg, B, dtype, x.device)

    # token shift: x_{t-1}, the state carrying the previous call's last
    x_prev = torch.cat([state["x_prev"][:, None, :].to(dtype), x[:, :-1]],
                       dim=1)

    def mix(m):
        return x * m.to(dtype) + x_prev * (1.0 - m).to(dtype)

    r = mix(p["mix_r"]) @ p["w_r"].to(dtype)
    k = mix(p["mix_k"]) @ p["w_k"].to(dtype)
    v = mix(p["mix_v"]) @ p["w_v"].to(dtype)
    g = F.silu(mix(p["mix_g"]) @ p["w_g"].to(dtype))
    # data-dependent decay (the "6" in rwkv6), clipped before the double exp
    decay_x = ((mix(p["mix_w"]) @ p["w_decay_a"].to(dtype))
               @ p["w_decay_b"].to(dtype))
    logw = -torch.exp(torch.clamp(p["decay_base"] + decay_x.float(),
                                  -20.0, 8.0))
    w = torch.exp(logw)                                     # in (0, 1)

    # time-major over batch x heads: r, v as rows, k, w as columns
    shape = (B, T, H, hd)
    rh, kh, vh = (_time_major(t, shape) for t in (r, k, v))
    wh = _time_major(w, shape)
    s_last, ys = chunked_time_scan(
        _rwkv_step, state["wkv"].reshape(B * H, hd, hd),
        (rh.view(T, B * H, 1, hd), kh.view(T, B * H, hd, 1),
         vh.view(T, B * H, 1, hd), wh.view(T, B * H, hd, 1)), chunk)
    # out_t = r (s + u k v^T): the current token's bonus path, in bulk
    bonus = (rh * p["bonus"] * kh).sum(-1, keepdim=True) * vh
    y = (ys.view(T, B, H, hd) + bonus).transpose(0, 1).reshape(B, T, d)

    y = _rwkv_group_norm(y.to(dtype), p["ln_w"], p["ln_b"], H) * g
    return y @ p["w_o"].to(dtype), {"wkv": s_last.view(B, H, hd, hd),
                                    "x_prev": x[:, -1, :]}


def rwkv6_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, state: State) -> Tuple[torch.Tensor, State]:
    """Single-token decode. x: (B, 1, d)."""
    return rwkv6_scan(p, x, cfg, state)


# ---------------------------------------------------------------------------
# RWKV channel mix (the MLP analogue; token shift too)
# ---------------------------------------------------------------------------
def init_rwkv6_channel_mix(generator: torch.Generator, cfg: ModelConfig,
                           lead: Tuple[int, ...] = ()
                           ) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    half = torch.full(lead + (d,), 0.5, dtype=torch.float32,
                      device=generator.device)
    return {
        "mix_k": half,
        "mix_r": half.clone(),
        "w_k": dense_init(generator, d, ff, lead=lead),
        "w_v": dense_init(generator, ff, d,
                          scale=1.0 / math.sqrt(2 * cfg.n_layers), lead=lead),
        "w_r": dense_init(generator, d, d, lead=lead),
    }


def rwkv6_channel_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      x_prev_last: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d); x_prev_last: (B, d), the previous call's last token.
    Returns (out, the new x_prev_last)."""
    B, T, d = x.shape
    dtype = x.dtype
    if x_prev_last is None:
        x_prev_last = torch.zeros((B, d), dtype=dtype, device=x.device)
    x_prev = torch.cat([x_prev_last[:, None, :].to(dtype), x[:, :-1]], dim=1)
    xk = x * p["mix_k"].to(dtype) + x_prev * (1 - p["mix_k"]).to(dtype)
    xr = x * p["mix_r"].to(dtype) + x_prev * (1 - p["mix_r"]).to(dtype)
    k = torch.square(F.relu(xk @ p["w_k"].to(dtype)))
    r = torch.sigmoid(xr @ p["w_r"].to(dtype))
    return r * (k @ p["w_v"].to(dtype)), x[:, -1, :]
