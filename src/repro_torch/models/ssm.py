"""Mamba-2 (SSD, state-space duality) block, ported from the reference's
``models/ssm.py``: in_proj -> [z | x | B | C | dt] as separate weights,
depthwise causal conv over (x, B, C), SiLU, the SSD recurrence, gated
RMSNorm, out_proj. Padded SSM heads are zero-masked before the gated
norm, whose denominator uses the true channel count.

The full-sequence SSD goes through the ``ssd_scan`` kernel wrapper
(``kernels/ssd_scan.py``: the hand-written CUDA kernel on the card, the
plain ``ssd_chunked`` below on the CPU); single-token decode is the plain
``ssd_decode`` recurrence, as in the reference.

Tensor parallelism (a step under ``policy.use_ctx_mesh`` on a 'model'
axis of more than 1, with ``w_x`` split by the policy): each rank holds
its SSM heads' ``w_z``, ``w_x``, ``w_dt``, ``conv_x``, ``conv_x_b``,
``a_log``, ``dt_bias``, ``d_skip``, ``norm_scale`` and ``w_out`` rows;
``w_b``, ``w_c``, ``conv_b`` and ``conv_c`` are replicated, and B and C
enter the rank's heads through ``policy.copy_to_tp``. The gated norm's
sum of squares runs over all of ``d_inner`` (an all-reduce of a (B, S, 1)
sum; its denominator is the global ``h_true * head_dim``), the padded
heads are masked by their global index, and ``w_out``'s products are
summed over the ranks. A decode cache holds the rank's heads
(``init_ssm_cache``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.common import _uniform, dense_init, pdtype
from repro_torch.sharding import policy


def init_ssm(gen, cfg, *, device):
    s = cfg.ssm
    d = cfg.d_model
    din = cfg.d_inner_padded
    hp = cfg.ssm_heads_padded
    gn = s.n_groups * s.d_state
    dt = pdtype(cfg)
    kconv = s.d_conv

    def dense(shape):
        return dense_init(gen, shape, 0, dt, device=device)

    def conv_w(ch):
        return (_uniform(gen, (ch, kconv), -1.0, 1.0, device) / kconv).to(dt)

    def zeros(n, dtype=dt):
        return torch.zeros((n,), dtype=dtype, device=device)

    p = {"w_z": dense((d, din)), "w_x": dense((d, din)),
         "w_b": dense((d, gn)), "w_c": dense((d, gn)),
         "w_dt": dense((d, hp)),
         "conv_x": conv_w(din), "conv_x_b": zeros(din),
         "conv_b": conv_w(gn), "conv_b_b": zeros(gn),
         "conv_c": conv_w(gn), "conv_c_b": zeros(gn)}
    a = _uniform(gen, (hp,), s.a_init_range[0], s.a_init_range[1], device)
    dt0 = torch.exp(_uniform(gen, (hp,), 0.0, 1.0, device)
                    * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    dt0 = torch.clamp(dt0, min=1e-4)
    p.update({
        "a_log": torch.log(a),                      # A = -exp(a_log), f32
        "dt_bias": torch.log(torch.expm1(dt0)),     # softplus inverse, f32
        "d_skip": torch.ones((hp,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((din,), dtype=dt, device=device),
        "w_out": dense((din, d)),
    })
    return p


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B,S,ch), w (ch,K). If ``state`` (B,ch,K-1)
    is given (decode), x is (B,1,ch) and the updated state is returned."""
    k = w.shape[1]
    if state is None:
        # tap i reads x shifted right by k-1-i: a slice of one padded copy
        # (the reference pads once per tap; the products and the order of
        # the sums are the same, and the backward has k-1 fewer pads)
        s = x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        wt = w.t()
        out = xp[:, :s] * wt[0]
        for i in range(1, k):
            out = out + xp[:, i:i + s] * wt[i]
        return out + b, None
    window = torch.cat([state, x.transpose(1, 2)], dim=2)      # (B,ch,K)
    out = torch.sum(window * w[None], dim=2)[:, None, :] + b
    return out, window[:, :, 1:]


def _segsum_decay(da_cum):
    """da_cum (..., L) -> lower-triangular exp(da_cum[i]-da_cum[j]) i>=j.
    Masked BEFORE exp: the upper triangle's positive exponents overflow."""
    li = da_cum[..., :, None] - da_cum[..., None, :]
    n = li.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool, device=li.device).tril()
    return torch.exp(li.masked_fill(~mask, float("-inf")))


def ssd_chunked(x, dtv, a, bmat, cmat, chunk, initial_state=None):
    """SSD over a full sequence, chunked (the plain version).
    x (B,S,H,P) head inputs; dtv (B,S,H) positive step sizes; a (H,)
    negative decay; bmat/cmat (B,S,N) (n_groups==1, shared across heads).
    Returns y (B,S,H,P) float32 and final state (B,H,P,N) float32."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"sequence {s} is not a multiple of chunk {l}")
    nc = s // l
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, l, h, p)
    dtf = dtv.to(f32).reshape(b, nc, l, h)
    bf = bmat.to(f32).reshape(b, nc, l, n)
    cf = cmat.to(f32).reshape(b, nc, l, n)

    da = dtf * a.to(f32)[None, None, None, :]              # (b,nc,l,h) <= 0
    # the running sum over each chunk as a product with a triangle of
    # ones, not torch.cumsum: PyTorch has no deterministic CUDA cumsum of
    # floats (it raises under torch.use_deterministic_algorithms), and
    # the training drill replays under that mode through this function
    # (the ssd_scan kernel's backward). This function is also
    # ``ssd_scan_ref``, the plain version the kernel is held against: the
    # product adds the same terms as the reference's cumsum, in another
    # order, so the two agree within f32 rounding
    upto = torch.ones((l, l), dtype=f32, device=x.device).triu()
    da_cum = torch.einsum("bcjh,jl->bclh", da, upto)
    xdt = xf * dtf[..., None]

    # intra-chunk (the "attention-like" quadratic-in-l term)
    cb = torch.einsum("bcln,bcsn->bcls", cf, bf)           # shared over h
    decay = _segsum_decay(da_cum.transpose(2, 3))          # (b,nc,h,l,l)
    y_diag = torch.einsum("bcls,bchls,bcshp->bclhp", cb, decay, xdt)

    # chunk -> state contributions
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (b,nc,l,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", bf, decay_to_end, xdt)

    # inter-chunk recurrence: the state ENTERING each chunk
    chunk_decay = torch.exp(da_cum[:, :, -1, :])           # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    states_in = torch.stack(entering, dim=1)               # (b,nc,h,p,n)

    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", cf, states_in,
                         torch.exp(da_cum))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def ssd_decode(x, dtv, a, bmat, cmat, state):
    """Single-token SSD update. x (B,1,H,P); state (B,H,P,N) float32."""
    f32 = torch.float32
    xf = x.to(f32)[:, 0]                                   # (B,H,P)
    dtf = dtv.to(f32)[:, 0]                                # (B,H)
    bf = bmat.to(f32)[:, 0]                                # (B,N)
    cf = cmat.to(f32)[:, 0]
    da = torch.exp(dtf * a[None, :])                       # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dtf, bf, xf)
    new_state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cf)
    return y[:, None], new_state                           # (B,1,H,P)


def _gated_norm(y, z, scale, true_dim: int, eps: float, tp=None):
    """RMSNorm(y * silu(z)) with the denominator using the TRUE channel
    count so zero-padded channels do not perturb real outputs. tp: the
    'model' axis whose ranks hold the other channels (their sums of
    squares are added; the sum's gradient too)."""
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
    ss = torch.sum(g * g, dim=-1, keepdim=True)
    if tp is not None:
        ss = policy.copy_to_tp(policy.reduce_from_tp(ss, tp), tp)
    ms = ss / true_dim
    return (g * torch.rsqrt(ms + eps)) * scale.to(torch.float32)


def ssm_split(p, cfg):
    """(the ambient 'model' axis, this rank's first SSM head) when ``p``
    holds a share of the SSM heads, else (None, 0)."""
    tp = policy.ctx_tp()
    if tp is None or p["w_x"].shape[1] == cfg.d_inner_padded:
        return None, 0
    hl = p["w_dt"].shape[1]
    if hl * tp.size != cfg.ssm_heads_padded:
        raise ValueError(f"{cfg.ssm_heads_padded} SSM heads do not split "
                         f"over {tp.size} 'model' ranks as d_inner does")
    return tp, tp.rank * hl


def apply_ssm(p, x, cfg, cache=None, collect_state: bool = False):
    """Full-sequence when cache is None; single-token decode otherwise.
    cache = {"conv_x","conv_b","conv_c","state"}. Returns (out, new_cache).
    collect_state=True (prefill): new_cache carries the decode-ready state
    (conv windows over the last K-1 raw projected inputs + final SSD state).
    """
    s = cfg.ssm
    b, seqlen, _ = x.shape
    hp, hd = cfg.ssm_heads_padded, s.head_dim
    h_true = cfg.ssm_heads
    tp, h0 = ssm_split(p, cfg)
    xs = x
    if tp is not None:
        hp = p["w_dt"].shape[1]
        xs = policy.copy_to_tp(x, tp)

    z = xs @ p["w_z"]
    xi = xs @ p["w_x"]
    bi = x @ p["w_b"]
    ci = x @ p["w_c"]
    dtv = F.softplus((xs @ p["w_dt"]).to(torch.float32)
                     + p["dt_bias"][None, None].to(torch.float32))

    decode = cache is not None
    k1 = s.d_conv - 1
    raw_windows = None
    if collect_state:
        raw_windows = tuple(t[:, -k1:].transpose(1, 2) for t in (xi, bi, ci))
    xi, conv_x = _causal_conv(xi, p["conv_x"], p["conv_x_b"],
                              cache["conv_x"] if decode else None)
    bi, conv_b = _causal_conv(bi, p["conv_b"], p["conv_b_b"],
                              cache["conv_b"] if decode else None)
    ci, conv_c = _causal_conv(ci, p["conv_c"], p["conv_c_b"],
                              cache["conv_c"] if decode else None)
    xi, bi, ci = F.silu(xi), F.silu(bi), F.silu(ci)
    if tp is not None:     # replicated B, C into this rank's heads
        bi, ci = policy.copy_to_tp(bi, tp), policy.copy_to_tp(ci, tp)

    xh = xi.reshape(b, seqlen, hp, hd)
    a = -torch.exp(p["a_log"].to(torch.float32))
    if decode:
        y, state = ssd_decode(xh, dtv, a, bi, ci, cache["state"])
    else:
        y, state = ssd_scan(xh, dtv, a, bi, ci, chunk=s.chunk_size)
    y = y + xh.to(torch.float32) * p["d_skip"][None, None, :, None]

    if h0 + hp > h_true:  # zero padded heads before the coupling norm
        mask = (torch.arange(h0, h0 + hp, device=x.device) < h_true
                ).to(torch.float32)
        y = y * mask[None, None, :, None]
    y = y.reshape(b, seqlen, hp * hd)
    y = _gated_norm(y, z, p["norm_scale"], true_dim=h_true * hd,
                    eps=cfg.norm_eps, tp=tp).to(x.dtype)
    out = y @ p["w_out"]
    if tp is not None:
        out = policy.reduce_from_tp(out, tp)
    if decode:
        new_cache = dict(conv_x=conv_x, conv_b=conv_b, conv_c=conv_c,
                         state=state)
    elif collect_state:
        new_cache = dict(conv_x=raw_windows[0], conv_b=raw_windows[1],
                         conv_c=raw_windows[2], state=state)
    else:
        new_cache = None
    return out, new_cache


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, *, device):
    """One layer's decode cache: every SSM head's, or under the ambient
    'model' axis (where the policy splits ``d_inner``) this rank's."""
    s = cfg.ssm
    k = s.d_conv - 1
    gn = s.n_groups * s.d_state
    hp = cfg.ssm_heads_padded
    tp = policy.ctx_tp()
    if tp is not None and cfg.d_inner_padded % tp.size == 0:
        hp //= tp.size
    return dict(
        conv_x=torch.zeros((batch, hp * s.head_dim, k), dtype=dtype,
                           device=device),
        conv_b=torch.zeros((batch, gn, k), dtype=dtype, device=device),
        conv_c=torch.zeros((batch, gn, k), dtype=dtype, device=device),
        state=torch.zeros((batch, hp, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device),
    )
