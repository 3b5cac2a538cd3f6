"""Mamba2 / SSD (state-space duality, arXiv:2405.21060), a port of
``repro/models/ssm.py``.

Prefill uses the *chunked* SSD form: intra-chunk attention-like products
(O(S·Q) with chunk size Q) plus an inter-chunk recurrence over per-chunk
states (a sequential loop over the chunks where the reference runs an
associative scan; the two round differently, within the reference's own
2e-4 for chunked against sequential). Decode keeps an O(1) recurrent state
per layer.

Layout conventions (as in the reference):
  x        (B, S, H, P)       P = head_dim, H = d_inner / P heads
  dt       (B, S, H)          softplus-positive step sizes
  A        (H,)               negative reals (log-parameterized)
  B, C     (B, S, G, N)       N = d_state, G = n_groups (broadcast to heads)
  state    (B, H, P, N)

The inner projections route through ``core.yoco_linear`` (kernels K2-K4
in w8a8); the conv, the scan, ``softplus`` and the gated norm are plain
torch ops in the reference's order and dtypes (plain ``jnp`` there, in no
Pallas kernel). A given ``state`` dict (``conv`` (B, W-1, C), ``ssm`` (B,
H, P, N), the serving cache's f32 rows) is the prefill's initial state and
conv history, and prefill and decode write the new state into it IN PLACE.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import yoco_linear
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.models.layers import dense_init, keep, rmsnorm


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def dims(cfg) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    # in_proj emits [z, x, B, C, dt]
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                d_in_proj=d_in_proj)


def init_mamba2(gen: torch.Generator, cfg, *, device, leaf=keep) -> dict:
    """The reference's distributions: dt_bias so that softplus(dt_bias)
    spans [dt_min, dt_max] log-uniformly, A = -exp(a_log) with a_log =
    log(linspace(1, 16, H)), a unit D skip, the conv N(0, 1/W). ``leaf(name,
    w)`` takes in_proj and out_proj right after their draws."""
    s = cfg.ssm
    dm = dims(cfg)
    h = dm['n_heads']
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = leaf('in_proj', dense_init(gen, cfg.d_model, dm['d_in_proj'],
                                         device=device))
    conv_w = torch.randn((s.conv_width, dm['conv_dim']), generator=gen,
                         **f32) / math.sqrt(s.conv_width)
    u = torch.rand((h,), generator=gen, **f32)
    dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                        + math.log(s.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inv softplus
    a_log = torch.ones((h,), **f32) * torch.log(
        torch.linspace(1.0, 16.0, h, **f32))
    out_proj = leaf('out_proj', dense_init(gen, dm['d_inner'], cfg.d_model,
                                           device=device))
    return dict(in_proj=in_proj, conv_w=conv_w,
                conv_b=torch.zeros((dm['conv_dim'],), **f32),
                a_log=a_log, d_skip=torch.ones((h,), **f32),
                dt_bias=dt_bias,
                gate_norm=torch.zeros((dm['d_inner'],), **f32),
                out_proj=out_proj)


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    s = cfg.ssm
    dm = dims(cfg)
    return dict(
        conv=torch.zeros((batch, s.conv_width - 1, dm['conv_dim']),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, dm['n_heads'], s.head_dim, s.d_state),
                        dtype=dtype, device=device))


# ----------------------------------------------------------------------------
# per-slot state ops (the RecurrentLayout's primitives; in place)
# ----------------------------------------------------------------------------
def slot_reset(state: dict, slots, axis: int = 0) -> dict:
    """Zero the given batch rows of a recurrent state dict, in place: what
    the continuous scheduler runs on admit and on evict/preempt, so idle
    lanes decode against zeroed state and a re-admitted request recomputes
    from scratch. ``axis`` is the batch axis (1 for (L,)-stacked trees).
    Each row is a Python-int view: no index tensor reaches the device."""
    for a in state.values():
        for slot in slots:
            a.select(axis, int(slot)).zero_()
    return state


def slot_snapshot(state: dict, slot: int, axis: int = 0) -> dict:
    """Batch-1 copy of one slot's (conv, ssd) state: the admission
    prefill's rows (a copy, as the reference's, so the full tree's rows
    change only through :func:`slot_restore`)."""
    return {k: a.narrow(axis, slot, 1).clone() for k, a in state.items()}


def slot_restore(state: dict, snap: dict, slot: int, axis: int = 0) -> dict:
    """Write a batch-1 snapshot back into ``slot``'s rows, in place: the
    inverse of :func:`slot_snapshot`."""
    for k, a in state.items():
        a.select(axis, slot).copy_(snap[k].select(axis, 0))
    return state


# ----------------------------------------------------------------------------
# chunked SSD core
# ----------------------------------------------------------------------------
def _heads(t: torch.Tensor, h: int, axis: int) -> torch.Tensor:
    """Broadcast G groups at ``axis`` to H heads, each group repeated
    H / G times in a row (``jnp.repeat``'s order), as a view and a copy:
    no repeat count reaches the device."""
    g = t.shape[axis]
    shape = t.shape[:axis] + (g, h // g) + t.shape[axis + 1:]
    return t.unsqueeze(axis + 1).expand(shape).reshape(
        t.shape[:axis] + (h,) + t.shape[axis + 1:])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) lower-tri segment sums:
    out[.., i, j] = sum_{j < k <= i} x[.., k]; -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float('-inf'))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward. x (B,S,H,P); dt (B,S,H); a (H,); b/c (B,S,G,N).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    f32 = torch.float32

    xf = x.to(f32).reshape(bsz, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(bsz, nc, chunk, h)
    bf = b.to(f32).reshape(bsz, nc, chunk, g, n)
    cf = c.to(f32).reshape(bsz, nc, chunk, g, n)
    bf = _heads(bf, h, 3)                                   # (B,nc,Q,H,N)
    cf = _heads(cf, h, 3)

    da = dtf * a.to(f32)                                    # (B,nc,Q,H) <= 0
    da = torch.movedim(da, -1, 1)                           # (B,H,nc,Q)
    da_cs = torch.cumsum(da, dim=-1)

    xdt = xf * dtf[..., None]                               # dt-weighted input

    # 1. intra-chunk (diagonal blocks): C·B scores, decayed, times x·dt
    ell = torch.exp(_segsum(da))                            # (B,H,nc,Q,Q)
    scores = torch.einsum('bclhn,bcshn->bhcls', cf, bf) * ell
    del ell
    y_diag = torch.einsum('bhcls,bcshp->bclhp', scores, xdt)
    del scores

    # 2. per-chunk final states
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)       # (B,H,nc,Q)
    states = torch.einsum('bclhn,bhcl,bclhp->bchpn', bf, decay_states, xdt)

    # 3. inter-chunk recurrence over chunk states, the initial state folded
    #    into the first: state_out[c] = decay[c] * state_out[c-1] + states[c]
    chunk_decay = torch.exp(da_cs[..., -1])                 # (B,H,nc)
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    init_state = init_state.to(f32)
    prev = [init_state]
    for k in range(nc):
        prev.append(chunk_decay[:, :, k, None, None] * prev[-1]
                    + states[:, k])
    final_state = prev[-1]
    prev = torch.stack(prev[:-1], dim=1)                    # (B,nc,H,P,N)

    # 4. inter-chunk contribution to the outputs
    state_decay_out = torch.exp(da_cs)                      # (B,H,nc,Q)
    y_off = torch.einsum('bclhn,bchpn,bhcl->bclhp', cf, prev,
                         state_decay_out)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, final_state


def ssd_step(x_t: torch.Tensor, dt_t: torch.Tensor, a: torch.Tensor,
             b_t: torch.Tensor, c_t: torch.Tensor, state: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step (decode). x_t (B,H,P); dt_t (B,H);
    b_t/c_t (B,G,N); state (B,H,P,N) -> (y (B,H,P), new_state)."""
    f32 = torch.float32
    h = x_t.shape[1]
    bf = _heads(b_t.to(f32), h, 1)                              # (B,H,N)
    cf = _heads(c_t.to(f32), h, 1)
    da = torch.exp(dt_t.to(f32) * a.to(f32))                    # (B,H)
    upd = (x_t.to(f32) * dt_t.to(f32)[..., None])[..., None] * bf[:, :, None]
    new_state = da[..., None, None] * state + upd
    y = torch.matmul(new_state, cf[..., None])[..., 0]      # sum over n
    return y, new_state


# ----------------------------------------------------------------------------
# full Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ----------------------------------------------------------------------------
def _split_in_proj(zxbcdt: torch.Tensor, cfg):
    s = cfg.ssm
    dm = dims(cfg)
    di, gn = dm['d_inner'], s.n_groups * s.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + dm['conv_dim']]
    dt = zxbcdt[..., di + dm['conv_dim']:]
    return z, xbc, dt, di, gn


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d. xbc (B,S,C); w (W,C). ``history``: (B,W-1,C)
    left context, else zero padding. The taps multiply the (promoted)
    activations by the f32 weights, so the output is f32, as the
    reference's."""
    width = w.shape[0]
    if history is None:
        history = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                              dtype=xbc.dtype, device=xbc.device)
    dt = torch.promote_types(history.dtype, xbc.dtype)
    xp = torch.cat([history.to(dt), xbc.to(dt)], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + bias[None, None, :])


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0), with no
    threshold past which it returns x (``F.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gate(p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y * silu(z in f32) in y's dtype, 1 + gate_norm): out_proj's
    input."""
    return rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype),
                   p['gate_norm'])


def mamba2_forward(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                   state: Optional[dict] = None, last_pos=None,
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence forward. x (B,S,d). Returns (out (B,S,d), ``state``
    with the final conv window and ssd state written into it in place, or
    None when no state was given).

    ``last_pos``: optional (B,) per-request last valid positions (a
    right-padded ragged prefill). Positions past it get ``dt = 0``, so
    ``exp(0 * a) = 1`` carries the state through unchanged and the
    dt-weighted input adds nothing (the identity ``ssd_chunked``'s own
    chunk padding uses); the conv window is gathered from the last valid
    rows, so a padded prompt leaves the state an unpadded one would."""
    s_cfg = cfg.ssm
    bsz, s, _ = x.shape
    dm = dims(cfg)
    zxbcdt = yoco_linear.linear(x, p['in_proj'], cfg=yoco)
    z, xbc_raw, dt, di, gn = _split_in_proj(zxbcdt, cfg)
    hist = state['conv'] if state is not None else None
    xbc = _causal_conv(xbc_raw, p['conv_w'], p['conv_b'], hist)
    xs = xbc[..., :di]
    b = xbc[..., di:di + gn].reshape(bsz, s, s_cfg.n_groups, s_cfg.d_state)
    c = xbc[..., di + gn:].reshape(bsz, s, s_cfg.n_groups, s_cfg.d_state)
    dt = softplus(dt.to(torch.float32) + p['dt_bias'])
    lp = None
    if last_pos is not None:
        lp = torch.as_tensor(last_pos, dtype=torch.int64,
                             device=x.device).reshape(-1, 1)
        valid = torch.arange(s, device=x.device)[None, :] <= lp
        dt = torch.where(valid[..., None], dt, 0.0)
    a = -torch.exp(p['a_log'])
    xh = xs.reshape(bsz, s, dm['n_heads'], s_cfg.head_dim)

    chunk = min(s_cfg.chunk_size, s)
    pad = (-s) % chunk
    xh_p, dt_p, b_p, c_p = xh, dt, b, c
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        b_p = F.pad(b, (0, 0, 0, 0, 0, pad))
        c_p = F.pad(c, (0, 0, 0, 0, 0, pad))
    init = state['ssm'].to(torch.float32) if state is not None else None
    y, fin = ssd_chunked(xh_p, dt_p, a, b_p, c_p, chunk, init)
    if pad:
        y = y[:, :s]
    y = y + xh * p['d_skip'][None, None, :, None]           # D skip
    y = y.reshape(bsz, s, di).to(x.dtype)
    out = yoco_linear.linear(_gate(p, y, z), p['out_proj'], cfg=yoco)
    if state is None:
        return out, None
    w = s_cfg.conv_width
    conv = state['conv']
    tail = torch.cat([conv, xbc_raw.to(conv.dtype)], dim=1)
    if lp is None:
        conv_next = tail[:, -(w - 1):]
    else:
        # the last w-1 VALID rows: tail row j holds sequence position
        # j - (w-1), so positions last_pos-w+2 .. last_pos sit at tail rows
        # last_pos+1 .. last_pos+w-1
        idx = lp + 1 + torch.arange(w - 1, device=x.device)[None, :]
        conv_next = torch.gather(
            tail, 1, idx[..., None].expand(-1, -1, tail.shape[-1]))
    conv.copy_(conv_next)
    state['ssm'].copy_(fin)
    return out, state


def mamba2_decode(p: dict, x: torch.Tensor, cfg, yoco: YocoConfig, *,
                  state: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x (B,1,d); ``state`` dict(conv (B,W-1,C), ssm
    (B,H,P,N)), updated in place by :func:`decode_core`."""
    zxbcdt = yoco_linear.linear(x, p['in_proj'], cfg=yoco)
    y = decode_core(p, zxbcdt, cfg, state)
    return yoco_linear.linear(y, p['out_proj'], cfg=yoco), state


def decode_core(p: dict, zxbcdt: torch.Tensor, cfg,
                state: dict) -> torch.Tensor:
    """A decode step's SSM ops between in_proj and out_proj: the conv over
    the stored window, softplus, the SSD step, the D skip and the gated
    norm. ``zxbcdt`` (B,1,d_in_proj) in the compute dtype; returns
    out_proj's (B,1,d_inner) input in that dtype. The new window and state
    are computed whole before either is written into ``state``."""
    s_cfg = cfg.ssm
    bsz = zxbcdt.shape[0]
    dm = dims(cfg)
    z, xbc, dt, di, gn = _split_in_proj(zxbcdt, cfg)
    conv = state['conv']
    win = torch.cat([conv, xbc.to(conv.dtype)], dim=1)      # (B, W, C)
    conv_out = (win.to(torch.float32) * p['conv_w']).sum(1) + p['conv_b']
    xbc_t = F.silu(conv_out)                                # (B, C)
    xs = xbc_t[..., :di]
    b = xbc_t[..., di:di + gn].reshape(bsz, s_cfg.n_groups, s_cfg.d_state)
    c = xbc_t[..., di + gn:].reshape(bsz, s_cfg.n_groups, s_cfg.d_state)
    dt_t = softplus(dt[:, 0].to(torch.float32) + p['dt_bias'])
    a = -torch.exp(p['a_log'])
    xh = xs.reshape(bsz, dm['n_heads'], s_cfg.head_dim)
    y, new_ssm = ssd_step(xh, dt_t, a, b, c, state['ssm'].to(torch.float32))
    y = y + xh * p['d_skip'][None, :, None]
    y = _gate(p, y.reshape(bsz, 1, di).to(zxbcdt.dtype), z)
    conv.copy_(win[:, 1:])
    state['ssm'].copy_(new_ssm)
    return y


def ssd_reference(x, dt, a, b, c, init_state=None):
    """The exact sequential recurrence, the oracle of ``ssd_chunked``
    (slow: one :func:`ssd_step` a position)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.to(torch.float32))
    ys = []
    for t in range(s):
        y, state = ssd_step(x[:, t].to(torch.float32),
                            dt[:, t].to(torch.float32), a, b[:, t], c[:, t],
                            state)
        ys.append(y)
    return torch.stack(ys, dim=1), state
