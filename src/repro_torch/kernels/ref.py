"""Plain PyTorch versions of the port's kernels (the port's ``ref.py``).

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the path a wrapper takes for tensors on the CPU.  They
compute in f32 (the contraction in f64 for f64 arrays) and return their
input's dtype.

Two deliberate differences from the JAX package's ``ref``:

* a query row that sees no key (``length == 0``, or a causal row before the
  first key) returns 0, as the kernels' ``l == 0`` guard intends, where
  ``repro.kernels.ref`` returns NaN;
* ``jacobi2d`` computes each sweep in f32 and rounds once to the input's
  dtype, as the TPU kernel ``_jacobi_kernel`` does, where
  ``repro.kernels.ref.jacobi2d`` computes in the input's dtype (in bf16 the
  two differ by up to 0.0078 at (128, 64) over 3 steps).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 sums, cast to x's dtype."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)


def jacobi2d(x: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """``steps`` Jacobi-2D sweeps of (M, N): each sets the interior to
    0.2 * (N + S + W + E + C) in f32 and rounds once to x's dtype; the
    boundary rows and columns pass through.  ``steps = 0`` returns x."""
    for _ in range(steps):
        a = x.float()
        out = a.clone()
        out[1:-1, 1:-1] = 0.2 * (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2] + a[1:-1, 2:]
                                 + a[1:-1, 1:-1])
        x = out.to(x.dtype)
    return x


def jacobi2d_blocked(x: torch.Tensor, steps: int, sweeps: int, tile: tuple) -> torch.Tensor:
    """``jacobi2d`` computed as ``csrc/stencil.cu``'s multi-sweep kernel
    computes it: each launch of up to ``sweeps`` sweeps cuts the grid into
    ``tile`` blocks, sweeps each block's tile and a halo of that many cells
    on its own (the valid region shrinking by a cell a sweep, the cells
    outside the grid zero) and keeps the tile.  Bit-equal to ``jacobi2d``."""
    m, n = x.shape
    bm, bn = tile
    for i in range(0, steps, sweeps):
        t = min(sweeps, steps - i)
        pad = torch.zeros(m + 2 * t, n + 2 * t, dtype=torch.float32)
        pad[t:t + m, t:t + n] = x.float()
        rows = torch.arange(-t, m + t)[:, None]
        cols = torch.arange(-t, n + t)[None, :]
        inner = (rows > 0) & (rows < m - 1) & (cols > 0) & (cols < n - 1)
        out = torch.empty(m, n, dtype=x.dtype)
        for r0 in range(0, m, bm):
            for c0 in range(0, n, bn):
                blk = pad[r0:r0 + bm + 2 * t, c0:c0 + bn + 2 * t].clone()
                keep = inner[r0:r0 + bm + 2 * t, c0:c0 + bn + 2 * t]
                for k in range(1, t + 1):
                    new = blk.clone()
                    sweep = 0.2 * (blk[k - 1:-k - 1, k:-k] + blk[k + 1:blk.shape[0] - k + 1, k:-k]
                                   + blk[k:-k, k - 1:-k - 1]
                                   + blk[k:-k, k + 1:blk.shape[1] - k + 1] + blk[k:-k, k:-k])
                    new[k:-k, k:-k] = torch.where(keep[k:-k, k:-k],
                                                  sweep.to(x.dtype).float(), blk[k:-k, k:-k])
                    blk = new
                tr, tc = min(bm, m - r0), min(bn, n - c0)
                out[r0:r0 + tr, c0:c0 + tc] = blk[t:t + tr, t:t + tc].to(x.dtype)
        x = out
    return x


def _softmax_av_parts(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor):
    """(softmax over the last axis of ``s`` restricted to ``mask``, times v;
    each row's max m and sum l of exp(s - m) over the mask, keepdim).  Rows
    with no True in ``mask`` give 0 and l = 0."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), dtype=s.dtype, device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v)
    return o / torch.where(l == 0, torch.ones_like(l), l), m, l


def _softmax_av(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _softmax_av_parts(s, mask, v)[0]


def _scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: Optional[float]):
    """(scale * Q K^T in f32, the visible-key mask, K and V in f32 with each kv
    head repeated over its group, scale)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kr.transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kj = torch.arange(skv, device=q.device)[None, :]
        mask = (kj <= qi).expand(b, hq, sq, skv)
    else:
        mask = torch.ones(b, hq, sq, skv, dtype=torch.bool, device=q.device)
    return s, mask, kr, vr, scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) with GQA broadcast.

    Causal: query i attends to keys j <= i + (Skv - Sq) (aligned suffixes)."""
    s, mask, _, vr, _ = _scores(q, k, v, causal, scale)
    return _softmax_av(s, mask, vr).to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None):
    """``attention`` (the same operations, so the same bits) and each row's
    log-sum-exp of its scaled scores over the keys it sees: (o, lse (B, Hq,
    Sq) f32, natural log; -inf for a row that sees no key)."""
    s, mask, _, vr, _ = _scores(q, k, v, causal, scale)
    o, m, l = _softmax_av_parts(s, mask, vr)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, -math.inf))
    return o.to(q.dtype), lse[..., 0]


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                       scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of ``attention`` for the output gradient ``do``,
    from its output ``o`` and ``lse`` (of ``attention_lse``), by the explicit
    formula the backward kernel computes, in f32:
    P = exp(S scale - lse) (0 where masked), dV = sum_group P^T dO,
    dP = dO V^T, Delta = rowsum(dO o O), dS = P o (dP - Delta),
    dQ = scale dS K, dK = scale sum_group dS^T Q.  The query heads of a
    group sum into their kv head; a row that sees no key gets 0."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    s, mask, kr, vr, scale = _scores(q, k, v, causal, scale)
    # where no entry of a row is visible its lse is -inf: every entry masked
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    dof, qf = do.float(), q.float()
    dv = torch.matmul(p.transpose(-1, -2), dof).reshape(b, hkv, group, skv, d).sum(2)
    dp = torch.matmul(dof, vr.transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kr) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf).reshape(b, hkv, group, skv, d).sum(2) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode. q: (B, Hq, D), k/v: (B, Hkv, S, D).

    ``length``: (B,) valid KV prefix per batch row (None = full)."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kr) * scale
    if length is None:
        mask = torch.ones(b, hq, s_len, dtype=torch.bool, device=q.device)
    else:
        pos = torch.arange(s_len, device=q.device)
        mask = (pos[None, :] < length.to(q.device)[:, None])[:, None, :].expand(b, hq, s_len)
    o = _softmax_av(s[:, :, None, :], mask[:, :, None, :], vr)
    return o[:, :, 0, :].to(q.dtype)


def offset_grid(trips, coefs, base: int, device) -> torch.Tensor:
    """Flattened element offsets ``base + sum_d idx_d * coef_d`` over the box
    of ``trips``, the first dim outermost (contiguous int64)."""
    off = torch.full((), base, dtype=torch.long, device=device)
    for t, c in zip(trips, coefs):
        off = off[..., None] + torch.arange(t, device=device) * c
    return off.reshape(-1).contiguous()


def _strided(t: torch.Tensor, trips, coefs, base: int, lane: Optional[int]) -> tuple:
    """The view of ``t`` at the element offsets ``base + sum_d idx_d * coef_d``
    over the dims with a nonzero coefficient (a leading lane dim of stride
    ``lane`` when given): ``(view, [(position, dim)])``.  A dim with a
    negative coefficient is walked from its far end with the positive
    stride, so its axis runs reversed (``flip`` it back)."""
    size, stride, dims, neg = [], [], [], []
    if lane is not None:
        size, stride = [t.numel() // lane], [lane]
    for d, (n, c) in enumerate(zip(trips, coefs)):
        if c:
            if c < 0:
                base += c * (n - 1)
                neg.append(len(size))
            size.append(n)
            stride.append(abs(c))
            dims.append(d)
    flat = t.reshape(-1)
    return flat.as_strided(size, stride, flat.storage_offset() + base), dims, neg


def contraction(desc, x: torch.Tensor, y: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.contraction``: X, Y and D as strided views
    over the statement's dims (no copies where the coefficients allow it),
    ``einsum`` over the dims each operand moves with in f32 (f64 for f64
    D), added to D's initial contents and cast to D's dtype.  A reduction
    dim neither operand moves with multiplies the sum by its trip count; an
    output dim neither moves with broadcasts.  Lanes as in the wrapper: a
    tensor of ``k * numel`` elements holds k lanes, one lane is shared.
    D's store must be injective, as the kernel requires."""
    acc = torch.float64 if init.dtype == torch.float64 else torch.float32
    batch = init.numel() // desc.o_numel
    out = init.clone()
    if batch * desc.points * desc.red_points == 0:
        return out
    trips = desc.out_trips + desc.red_trips
    n_out = len(desc.out_trips)
    letters = [chr(ord("a") + i) if i < 26 else chr(ord("A") + i - 26)
               for i in range(len(trips))]
    ops, subs = [], []
    for t, numel, coefs, base in ((x, desc.x_numel, desc.out_x + desc.red_x, desc.x0),
                                  (y, desc.y_numel, desc.out_y + desc.red_y, desc.y0)):
        lane = numel if batch > 1 and t.numel() == batch * numel else None
        v, dims, neg = _strided(t, trips, coefs, base, lane)
        ops.append(v.flip(neg).to(acc) if neg else v.to(acc))
        subs.append(("Z" if lane else "") + "".join(letters[d] for d in dims))
    moved = set(subs[0]) | set(subs[1])
    kept = [d for d in range(n_out) if letters[d] in moved]
    lead = "Z" if "Z" in moved else ""
    s = torch.einsum(f"{subs[0]},{subs[1]}->{lead}{''.join(letters[d] for d in kept)}", *ops)
    for d in range(n_out, len(trips)):
        if letters[d] not in moved:
            s = s * trips[d]
    s = s.reshape(((batch if lead else 1,) if batch > 1 else ()) +
                  tuple(n if d in kept else 1 for d, n in enumerate(desc.out_trips)))
    ov, dims, neg = _strided(out, desc.out_trips, desc.out_o, desc.o0,
                             desc.o_numel if batch > 1 else None)
    if len(dims) != n_out:
        raise ValueError("contraction: D's store does not move with every output dim")
    cur = ov.flip(neg) if neg else ov
    new = (cur.to(acc) + s).to(init.dtype)
    ov.copy_(new.flip(neg) if neg else new)
    return out


def probe(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.probe``: ``x + 1``."""
    return x + 1


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert matmul in f32, cast to x's dtype.
    x: (E, cap, d), w: (E, d, f) -> (E, cap, f)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None):
    """Mamba2-style selective scan (scalar decay per head), one time step at
    a time in f32.

    x: (B, S, H, P) inputs; a: (B, S, H) decay in (0, 1]; b, c: (B, S, H, N)
    (a head stride of 0 broadcasts one group over the heads); h0: (B, H, N, P)
    f32 or None (zeros).  Returns y (B, S, H, P) in x's dtype and the final
    h (B, H, N, P) in f32:  h_t = a_t h_{t-1} + b_t (x) x_t,  y_t = c_t . h_t."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    h = (torch.zeros(bsz, nh, n, p, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float().clone())
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        h = af[:, t, :, None, None] * h + bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(bsz, 0, nh, p)
    return y.to(x.dtype), h


def ssm_scan_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     h0: Optional[torch.Tensor] = None, chunk: int = 64):
    """``ssm_scan`` in ``csrc/ssm_scan.cu``'s decomposition, in f32: the
    chunk states S_c = B^T diag(exp(cum_L - cum)) X of every chunk, the pass
    h_{c+1} = exp(cum_L) h_c + S_c over them, and the readout y = (C B^T *
    tril(exp(cum_t - cum_s))) X + (C * exp(cum)) h_c (cum the inclusive cumsum
    of log max(a, 1e-20) within the chunk).  The counterpart of the JAX
    package's ``ref.ssm_scan_chunked``; any S (the tail chunk padded with a =
    1, b = c = x = 0).  Same arguments and results as ``ssm_scan``."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    L = chunk
    nc = -(-s // L)
    pad = nc * L - s

    def chunks(t: torch.Tensor, fill: float) -> torch.Tensor:
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_full((bsz, pad) + t.shape[2:], fill)], dim=1)
        return t.reshape((bsz, nc, L) + t.shape[2:])

    xc, ac, bc, cc = chunks(x, 0.0), chunks(a, 1.0), chunks(b, 0.0), chunks(c, 0.0)
    cum = torch.cumsum(torch.log(torch.clamp(ac, min=1e-20)), dim=2)        # (B, nc, L, H)
    # 1. the chunk states and decays
    w = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bclhn,bclhp->bchnp", bc * w[..., None], xc)     # (B, nc, H, N, P)
    decay = torch.exp(cum[:, :, -1])                                        # (B, nc, H)
    # 2. the pass over the chunks: h_in[c] is the state entering chunk c
    h = (torch.zeros(bsz, nh, n, p, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = decay[:, ci, :, None, None] * h + states[:, ci]
    # 3. the readout
    g = torch.einsum("bclhn,bcshn->bchls", cc, bc)
    dt = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(0, 1, 4, 2, 3)  # (B,nc,H,L,L)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    m = torch.where(tri, torch.exp(torch.where(tri, dt, torch.zeros_like(dt))), 0.0) * g
    y = torch.einsum("bchls,bcshp->bclhp", m, xc)
    if nc:
        hs = torch.stack(h_in, dim=1)                                       # (B, nc, H, N, P)
        y = y + torch.einsum("bclhn,bchnp->bclhp", cc * torch.exp(cum)[..., None], hs)
    y = y.reshape(bsz, nc * L, nh, p)[:, :s]
    return y.to(x.dtype), h


def grouped_matmul_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """Gradients (dx, dw) of ``grouped_matmul(x, w)`` for the output gradient
    ``dy`` (E, cap, f), in f32, cast to x's and w's dtypes:
    dx = dy w^T (E, cap, d), dw = x^T dy (E, d, f), each per expert."""
    dyf = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dyf, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dyf).to(w.dtype)
    return dx, dw


def ssm_scan_backward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None):
    """Gradients (dx, da, db, dc) of ``ssm_scan(x, a, b, c)`` (from h = 0) for
    the output gradients ``dy`` (B, S, H, P) and ``dh_final`` (B, H, N, P) or
    None, by the sequential reverse recursion in f32:

        lambda_t = c_t (x) dy_t + a_{t+1} lambda_{t+1},  lambda_{S-1} starting
        from c (x) dy + dh_final;
        dx_t = b_t . lambda_t,  db_t = lambda_t x_t,  dc_t = h_t dy_t,
        da_t = sum(lambda_t * h_{t-1}).

    The forward states h_t are recomputed.  Each gradient in its input's
    dtype and shape (for a b or c that broadcasts one group over the heads,
    the per-head gradient: autograd's ``expand`` sums it)."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    dyf = dy.float()
    h = torch.zeros(bsz, nh, n, p, dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        hs.append(h)                                         # h_{t-1}
        h = af[:, t, :, None, None] * h + bf[:, t, :, :, None] * xf[:, t, :, None, :]
    hs.append(h)
    lam = (torch.zeros_like(h) if dh_final is None else dh_final.float().clone())
    dx, da, db, dc = (torch.zeros_like(xf), torch.zeros_like(af),
                      torch.zeros(bsz, s, nh, n, dtype=torch.float32, device=x.device),
                      torch.zeros(bsz, s, nh, n, dtype=torch.float32, device=x.device))
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            lam = af[:, t + 1, :, None, None] * lam
        lam = lam + cf[:, t, :, :, None] * dyf[:, t, :, None, :]
        dx[:, t] = torch.einsum("bhn,bhnp->bhp", bf[:, t], lam)
        db[:, t] = torch.einsum("bhnp,bhp->bhn", lam, xf[:, t])
        dc[:, t] = torch.einsum("bhnp,bhp->bhn", hs[t + 1], dyf[:, t])
        da[:, t] = (lam * hs[t]).sum((-1, -2))
    return dx.to(x.dtype), da.to(a.dtype), db.to(b.dtype), dc.to(c.dtype)


# the forward kernel's floor on a: it computes with log max(a, A_FLOOR)
A_FLOOR = 1e-20


def ssm_scan_da(c: torch.Tensor, dc: torch.Tensor, b: torch.Tensor, db: torch.Tensor,
                a: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``csrc/ssm_scan_bwd.cu``: the decay's gradient from
    the gradients of the readout and the input projection.  Per (batch,
    head), g_u = c_u . dc_u - b_u . db_u (dots over N), then d log a_t =
    sum_{u >= t} g_u (+ ``bias`` (B, H), the dh_final term) and da_t =
    d log a_t / a_t, 0 where a_t < A_FLOOR (the forward's clamp: there the
    scan does not depend on a_t).  The sums run in f64.  Returns (B, S, H)
    f32."""
    g = (c.double() * dc.double()).sum(-1) - (b.double() * db.double()).sum(-1)
    dlog = g.flip(1).cumsum(1).flip(1)
    if bias is not None:
        dlog = dlog + bias.double()[:, None, :]
    af = a.double()
    da = torch.where(af >= A_FLOOR, dlog / torch.clamp(af, min=A_FLOOR), torch.zeros_like(dlog))
    return da.float()
