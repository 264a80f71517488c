"""State-space and recurrent sequence mixers: the Mamba-style selective SSM
of Hymba's mamba heads, and xLSTM's mLSTM and sLSTM cells — the port of
``repro.models.ssm``, plain torch with autograd (the reference runs them
as XLA ops; none reaches a kernel).

A full sequence runs the reference's chunked forms: an associative scan
inside each chunk of ``CHUNK`` steps (the reference's own
``jax.lax.associative_scan`` tree, written out) with a sequential carry
across chunks for Mamba; a chunkwise-parallel form with per-chunk
log-space decays for mLSTM; a step-by-step loop for sLSTM.  Decode is the
same function at S = 1 with the carried state, as in the reference.

The reference's roundings are kept exactly: Mamba's scan elements ``da``
and ``dbx`` are rounded to bf16 whatever the model's dtype, the prefix
inside a chunk runs in f32, the per-step states come out in bf16 and are
widened to f32 for the output contraction; mLSTM pads its input gate with
-30 and sLSTM starts its stabilizer at -10.  One departure: the mLSTM masks
its intra-chunk log weights before the exp, where the reference masks
after it, so that the same values have a finite gradient over chunks
longer than about 128 steps (the reference's is NaN there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import project_heads
from .params import P

CHUNK = 256


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (Hymba's mamba heads)
# ---------------------------------------------------------------------------

def mamba_spec(d: int, d_inner: int, state: int, conv_k: int = 4) -> Dict:
    return {
        "w_in": P((d, 2 * d_inner), ("d_model", "d_inner2")),
        "conv_w": P((conv_k, d_inner), ("conv_k", "d_inner")),
        "w_dt": P((d_inner, d_inner), ("d_inner", "d_inner"), scale=0.1),
        "dt_bias": P((d_inner,), ("d_inner",), init="zeros"),
        "w_bc": P((d_inner, 2 * state), ("d_inner", "state2")),
        "a_log": P((d_inner, state), ("d_inner", "state"), init="zeros"),
        "d_skip": P((d_inner,), ("d_inner",), init="ones"),
        "w_out": P((d_inner, d), ("d_inner", "d_model")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence: x (B,S,C), w (K,C), state
    the last K-1 inputs (B,K-1,C).  Returns (out, new state)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                  # (B, S+K-1, C)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else state
    return out, new_state


def _combine(left: Tuple[torch.Tensor, torch.Tensor],
             right: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h -> a h + b composed: left first, then right."""
    (al, bl), (ar, br) = left, right
    return al * ar, bl * ar + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ... (even may be one
    longer)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1)


def _associative_scan(elems: Tuple[torch.Tensor, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` along dim 1, by the same tree of
    pairwise combines as ``jax.lax.associative_scan``: combine adjacent
    pairs, scan the pairs, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:n - 1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    rest = tuple(e[:, 2::2] for e in elems)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd), rest)
    else:
        even = _combine(odd, rest)
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _ssm_scan_chunked(da: torch.Tensor, dbx: torch.Tensor, h0: torch.Tensor,
                      chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = da_t * h_{t-1} + dbx_t, elementwise over (B,S,D,N) inputs.

    An associative scan inside each chunk, in f32, and a sequential carry
    across chunks (in f32, as ``h0``).  Returns (h for every t, in da's
    dtype; the final h).  ``da`` is padded with 1 and ``dbx`` with 0 to
    whole chunks, which leaves the carry unchanged."""
    S = da.shape[1]
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        da = F.pad(da, (0, 0, 0, 0, 0, pad), value=1.0)
        dbx = F.pad(dbx, (0, 0, 0, 0, 0, pad))
    h = h0
    outs = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        a_cum, b_cum = _associative_scan((da[:, sl].float(),
                                          dbx[:, sl].float()))
        h_all = a_cum * h[:, None] + b_cum               # (B, chunk, D, N)
        h = h_all[:, -1]
        outs.append(h_all.to(da.dtype))
    return torch.cat(outs, dim=1)[:, :S], h


def mamba_apply(params: Dict, x: torch.Tensor,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """x (B,S,d) -> (out (B,S,d), {'h': (B,D,N) f32, 'conv': (B,K-1,D)}).
    ``state`` (decode) carries the same two."""
    B = x.shape[0]
    D = params["w_in"].shape[1] // 2
    N = params["a_log"].shape[1]
    xs, z = (x @ params["w_in"]).chunk(2, dim=-1)
    conv_state = None if state is None else state["conv"]
    xs, new_conv = _causal_conv(xs, params["conv_w"].to(xs.dtype),
                                conv_state)
    xs = F.silu(xs)
    dt = F.softplus(xs @ params["w_dt"] + params["dt_bias"]).float()
    b_in, c_out = (xs @ params["w_bc"]).float().chunk(2, dim=-1)  # (B,S,N)
    a = -torch.exp(params["a_log"].float())                        # (D,N)
    # The scan elements in bf16 whatever the model's dtype, as in the
    # reference, where they dominate train-time memory; the carry is f32.
    da = torch.exp(dt[..., None] * a).to(torch.bfloat16)
    dbx = ((dt * xs.float())[..., None]
           * b_in[:, :, None, :]).to(torch.bfloat16)
    h0 = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
          if state is None else state["h"].float())
    h_seq, h_last = _ssm_scan_chunked(da, dbx, h0)
    y = torch.einsum("bsDn,bsn->bsD", h_seq.float(), c_out).to(x.dtype)
    y = y + xs * params["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    return y @ params["w_out"], {"h": h_last.float(), "conv": new_conv}


def mamba_init_state(batch: int, d_inner: int, state: int, conv_k: int = 4,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Dict:
    return {"h": torch.zeros((batch, d_inner, state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def mlstm_spec(d: int, n_heads: int, head_dim: int) -> Dict:
    return {
        "wq": P((d, n_heads, head_dim), ("d_model", "heads", "head_dim")),
        "wk": P((d, n_heads, head_dim), ("d_model", "heads", "head_dim")),
        "wv": P((d, n_heads, head_dim), ("d_model", "heads", "head_dim")),
        "w_if": P((d, 2 * n_heads), ("d_model", "heads2"), scale=0.1),
        "if_bias": P((2 * n_heads,), ("heads2",), init="zeros"),
        "wo": P((n_heads, head_dim, d), ("heads", "head_dim", "d_model")),
        "ogate": P((d, n_heads, head_dim), ("d_model", "heads", "head_dim"),
                   scale=0.1),
    }


def mlstm_apply(params: Dict, x: torch.Tensor, state: Optional[Dict] = None,
                chunk: int = CHUNK) -> Tuple[torch.Tensor, Dict]:
    """Chunkwise-parallel mLSTM: x (B,S,d) -> (out (B,S,d), {'C': (B,H,Dh,Dh),
    'n': (B,H,Dh)}, both f32).

    C_t = f_t C_{t-1} + i_t k_t v_t^T;  n_t = f_t n_{t-1} + i_t k_t;
    h_t = (q_t C_t) / max(|q_t n_t|, 1), with the gates' decays taken in
    log space inside each chunk (the reference's formulas)."""
    B, S, d = x.shape
    H, Dh = params["wq"].shape[1], params["wq"].shape[2]
    q = project_heads(x, params["wq"]) * (Dh ** -0.5)
    k = project_heads(x, params["wk"]) * (Dh ** -0.5)
    v = project_heads(x, params["wv"])
    gates = x @ params["w_if"] + params["if_bias"]
    i_pre, f_pre = gates.float().chunk(2, dim=-1)                # (B,S,H)
    log_f = -F.softplus(-f_pre)          # log sigmoid: forget in (0, 1)
    log_i = -F.softplus(-i_pre)          # the stabilized input gate

    C = None if state is None else state["C"]
    n = None if state is None else state["n"]
    h, (C, n) = _mlstm_scan(q, (k, v, log_f, log_i), (C, n), chunk)
    o_gate = torch.sigmoid(project_heads(x, params["ogate"]).float())
    h = (h * o_gate).to(x.dtype)
    wo = params["wo"]
    out = h.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
    return out, {"C": C, "n": n}


def _mlstm_scan(q, rest, carry, chunk: int):
    """The chunkwise recurrence: q and ``rest`` = (k, v, the log gates
    (B,S,H)), q, k, v (B,S,H,Dh), and the carried (C, n) (zeros for None)
    -> h (B,S,H,Dh) f32 and the last (C, n)."""
    k, v, log_f, log_i = rest
    C, n = carry
    B, S, H, Dh = q.shape
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-30.0)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()[None, :, :, None]
    C = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=q.device)
         if C is None else C)
    n = (torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
         if n is None else n)
    hs: List[torch.Tensor] = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb, lf, li = q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], \
            log_i[:, sl]
        qf, kf, vf = qb.float(), kb.float(), vb.float()
        lf_cum = lf.cumsum(dim=1)        # (B,chunk,H): log prod f_1..t
        dec_in = torch.exp(lf_cum)       # decay of the incoming state at t
        # a_{t,s} = exp(lf_cum_t - lf_cum_s + li_s) for s <= t.  Above the
        # diagonal w_log grows with the forget gates' decay (by about 0.69
        # a step at gates of 1/2), and its exp overflows past some 128
        # steps; the reference's where(mask, exp(w_log), 0) then takes
        # 0 * inf = NaN in the backward.  Masking before the exp gives the
        # same values and a zero gradient there.
        w_log = (lf_cum[:, :, None, :] - lf_cum[:, None, :, :]
                 + li[:, None, :, :])                            # (B,t,s,H)
        w = torch.exp(w_log.masked_fill(~mask, float("-inf")))
        sw = torch.einsum("bthk,bshk->btsh", qb, kb).float() * w
        intra_num = torch.einsum("btsh,bshv->bthv", sw, vf)
        intra_den = sw.sum(dim=2)                                # (B,t,H)
        inter_num = torch.einsum("bthk,bhkv->bthv", qf, C) * dec_in[..., None]
        inter_den = torch.einsum("bthk,bhk->bth", qf, n) * dec_in
        num = intra_num + inter_num
        den = (intra_den + inter_den).abs()[..., None]
        hs.append(num / den.clamp_min(1.0))
        # the state at the end of the chunk
        dec_k = torch.exp(lf_cum[:, -1:, :] - lf_cum + li)      # (B,chunk,H)
        kd = kf * dec_k[..., None]
        last = torch.exp(lf_cum[:, -1])
        C = C * last[..., None, None] + torch.einsum("bshk,bshv->bhkv", kd,
                                                     vf)
        n = n * last[..., None] + kd.sum(dim=1)
    return torch.cat(hs, dim=1)[:, :S], (C, n)


def mlstm_init_state(batch: int, n_heads: int, head_dim: int,
                     device="cuda") -> Dict:
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim),
                             dtype=torch.float32, device=device),
            "n": torch.zeros((batch, n_heads, head_dim), dtype=torch.float32,
                             device=device)}


def slstm_spec(d: int, n_heads: int) -> Dict:
    dh = d // n_heads
    return {
        "w_gates": P((d, 4 * d), ("d_model", "gates")),
        "r_gates": P((n_heads, dh, 4 * dh), ("heads", "head_dim", "gates_h"),
                     scale=0.5),
        "b_gates": P((4 * d,), ("gates",), init="zeros"),
        "w_out": P((d, d), ("d_model", "d_model_out")),
    }


def slstm_apply(params: Dict, x: torch.Tensor, state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Sequential sLSTM with exponential gating and a per-head recurrence:
    x (B,S,d) -> (out (B,S,d), {'c', 'n', 'm', 'h'} each (B,d) f32; m is
    the log-space stabilizer).  One step per token, as the reference's
    ``lax.scan``."""
    zx = (x @ params["w_gates"] + params["b_gates"]).float()
    r = params["r_gates"].float()
    carry = None if state is None else tuple(state[k] for k in "cnmh")
    hs, carry = _slstm_scan(zx, r, carry)
    out = hs.to(x.dtype) @ params["w_out"]
    return out, dict(zip("cnmh", carry))


def _slstm_scan(zx: torch.Tensor, r: torch.Tensor, carry=None):
    """The sLSTM's steps: the input gates zx (B,S,4d) f32 and the
    recurrent weights r (H,dh,4dh) -> the hidden states (B,S,d) f32 and
    the last (c, n, m, h)."""
    B, S, d = zx.shape[0], zx.shape[1], zx.shape[2] // 4
    H = r.shape[0]
    dh = d // H
    if carry is None:
        zeros = torch.zeros((B, d), dtype=torch.float32, device=zx.device)
        c, n, m, h = zeros, zeros, zeros - 10.0, zeros
    else:
        c, n, m, h = carry
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,hkg->bhg", h.reshape(B, H, dh), r)
        zi, zf, zz, zo = (zx[:, t] + rec.reshape(B, 4 * d)).chunk(4, dim=-1)
        log_f = -F.softplus(-zf)                   # log sigmoid(f)
        m_new = torch.maximum(log_f + m, zi)       # the stabilizer
        i = torch.exp(zi - m_new)
        f = torch.exp(log_f + m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / n.clamp_min(1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def slstm_init_state(batch: int, d: int, device="cuda") -> Dict:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "m": z - 10.0, "h": z.clone()}


__all__ = ["mamba_spec", "mamba_apply", "mamba_init_state", "mlstm_spec",
           "mlstm_apply", "mlstm_init_state", "slstm_spec", "slstm_apply",
           "slstm_init_state", "CHUNK"]
