"""The softmax and layout arms of the attention kernels: (B, Lq, D) q
against (B, Lk, D) k, v with D = num_heads * hd, returning (B, Lq, D); T4
takes heads already split and padded.

Port of the A/B variants in the JAX repository's tools/bench_attn_variants.py,
tools/bench_attn_round4.py, tools/bench_attn_sublane.py and
tools/bench_pv_transpose.py, named after them so each counterpart is found:

  nomax_attention      T2 <- nomax_attention / _nomax_kernel
  chunked_attention    T3 <- chunked_attention / _chunked_kernel
  nomax_unpadded       T5 <- nomax_unpadded / _nomax_unpadded_kernel
  pvt_attention        T9 <- pvt_attention / _pvt_kernel
  nomax_4d             T6 <- nomax_4d (T5's kernel over (B, L, h, hd) views)
  nomax_allheads       T7 <- nomax_allheads / _nomax_allheads_kernel
  nomax_laneslice      T8 <- nomax_laneslice / _nomax_laneslice_kernel
  slotted_kernel_call  T4 <- slotted_kernel_call (_attn_kernel, row max,
                       over (B*h, L, 128) head slots)
  sublane_attention    T1 <- sublane_attention / _sublane_kernel (the exact
                       row-max softmax, both products transposed)
  pv_product           T10 <- bench_shape / _pv_kernel (the P V product
                       alone, `iters` passes, in either orientation; over
                       (bh, bq, Lk) e and (bh, Lk, hd) v, not an attention)

T5 to T8 compute one function; what differs is where the heads are split:
by one copy pass outside the kernel (T5, as the TPU tool does), or inside
it, with the blocks mapped head-major (T6), all heads in one block (T7) or
head fastest (T8).

Each rounds where the TPU kernel rounds: q is multiplied by scale*log2(e) in
fp32 and rounded to its dtype before Q K^T, so s is the fp32 base-2 logit;
probabilities are rounded to v's dtype for P V (T9: kept fp32, v upcast;
T4 with exp2_bf16: bf16 whatever v's dtype), the row sum is fp32 and the
division comes after P V, rounded once. Flaws of the TPU wrappers are not
copied: their `Lk // bk` drops the tail keys (here `bk` must divide Lk, or
ValueError), and their `Lq // q_block` grid drops the tail queries (T4's,
unclamped, is empty below 512 queries): here every row is computed. The TPU
tile knobs (q_block, the 128-lane head pad, VMEM residency) are not part of
the functions and not ported.

T1's TPU wrapper pads Lq to its query block and returns the padded rows (it
raises on the final reshape where Lq is off the block); here every query
length is computed.

The kernels live in csrc/attn_arms.cu (T2, T3, T5, T9),
csrc/attn_layouts.cu (T6, T7, T8, and T4 in fp32), one register-resident
body (csrc/attn_arms.cuh, hd <= 160), and csrc/attn_transposed.cu (T1, and
T10 in fp32, over the same header's primitives). bf16 T4 runs K13's
two-pass wgmma/TMA kernel (csrc/flash_attention_sm90.cu
dtp_slotted_attention_sm90) and bf16 T10 a split wgmma/TMA GEMM whose
operands stay in shared memory (csrc/pv_product_sm90.cu); both raise
ValueError on operands TMA cannot describe. A wrapper takes its plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. `ops.attention.attention` and the served paths never
call these.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .attention import (
    _LOG2E,
    SM90_SOURCE,
    SM_COUNT,
    _check_qkv,
    _merge_heads,
    _prescaled,
    _softmax_pv,
    _split_heads,
)

MAX_HEAD_DIM = 160  # the kernel's 16 x hd fp32 accumulator per warp
DEFAULT_SHIFT = 32.0  # the JAX package's _NOMAX_SHIFT
CHUNK_WIDTHS = (64, 128)  # T3's kernel: the chunk is its K/V tile

nomax_launches = _cuda.LaunchCounter("nomax_attention")
chunked_launches = _cuda.LaunchCounter("chunked_attention")
nomax_unpadded_launches = _cuda.LaunchCounter("nomax_unpadded")
pvt_launches = _cuda.LaunchCounter("pvt_attention")
nomax_4d_launches = _cuda.LaunchCounter("nomax_4d")
nomax_allheads_launches = _cuda.LaunchCounter("nomax_allheads")
nomax_laneslice_launches = _cuda.LaunchCounter("nomax_laneslice")
slotted_launches = _cuda.LaunchCounter("slotted_kernel_call")
sublane_launches = _cuda.LaunchCounter("sublane_attention")
pv_product_launches = _cuda.LaunchCounter("pv_product")

_HEAD = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_float,)
_NOMAX_ARGTYPES = _HEAD + (ctypes.c_float,) + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
_CHUNKED_ARGTYPES = _HEAD + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_SHIFT_ARGTYPES = _HEAD + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_SUBLANE_ARGTYPES = _HEAD + (ctypes.c_int, ctypes.c_void_p)
_PV_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7
                + (ctypes.c_void_p,))
_SLOTTED_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                     + (ctypes.c_float,) + (ctypes.c_int,) * 2
                     + (ctypes.c_void_p,))
# bf16 T4 (K13's two-pass kernel): no dtype flag
_SLOTTED_SM90_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                          + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
# bf16 T10: e, v, out, work and its floats, then bh, bq, Lk, hd, iters,
# transposed, chunk, CTAs a (tile, chunk), then the stream
_PV_SM90_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
                     + (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
PV_SM90_SOURCE = "pv_product_sm90"
# bf16 T10's key chunks (TMA's box rows are at most 256) and query tile
PV_CHUNKS = (64, 128, 256)
PV_ROWS = 64


def _chunk(bk, lk: int) -> int:
    """The chunk width: Lk for None, else a positive divisor of Lk."""
    if bk is None:
        return lk
    if bk <= 0 or lk % bk:
        raise ValueError(f"bk={bk} must divide Lk={lk} (the TPU wrapper's "
                         "Lk // bk would drop the tail keys)")
    return bk


def _heads(q, k, v, num_heads):
    """(scale * log2(e))-prescaled q, k and v as (B, H, L, hd)."""
    hd = q.shape[-1] // num_heads
    scale_log2 = hd**-0.5 * _LOG2E
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    return (qh.float() * scale_log2).to(q.dtype), kh, vh


def _query_blocks(qs, width: int, block_bytes: int):
    """Query row ranges with at most `block_bytes` of (rows, width) fp32
    scores over all heads."""
    B, H, Lq, _ = qs.shape
    rows = max(1, block_bytes // (4 * B * H * width))
    return [(i, min(Lq, i + rows)) for i in range(0, Lq, rows)]


# --- plain versions ---


def plain_nomax_attention(q, k, v, num_heads: int, *,
                          shift: float = DEFAULT_SHIFT, safe: bool = False,
                          bf16_p: bool = False, bk: int | None = None,
                          block_bytes: int = 1 << 30):
    """T2's function. Per chunk of `bk` keys (all of Lk for None): s
    clamped at shift + 88 when `safe`; p = exp2(s - shift) in fp32, or
    exp2 of (s - shift) rounded to bf16 (a bf16 p) with `bf16_p`; l = sum p
    in fp32 (+1e-30 when `safe`); o = (p in v's dtype) v accumulated in
    fp32, / l. Without `safe`, logits above shift + 128 overflow to inf and
    NaN, as on the TPU."""
    qs, kh, vh = _heads(q, k, v, num_heads)
    Lk = kh.shape[2]
    bk = _chunk(bk, Lk)
    kt, vf = kh.float().transpose(-1, -2), vh.float()
    out = torch.empty(qs.shape, dtype=q.dtype, device=q.device)
    for i0, i1 in _query_blocks(qs, Lk, block_bytes):
        qb = qs[:, :, i0:i1].float()
        l = acc = 0.0
        for j in range(0, Lk, bk):
            s = torch.matmul(qb, kt[..., j:j + bk])
            if safe:
                s = torch.clamp_max(s, shift + 88.0)
            if bf16_p:
                p = torch.exp2((s - shift).to(torch.bfloat16))
            else:
                p = torch.exp2(s - shift)
            l = l + p.float().sum(-1, keepdim=True)
            acc = acc + torch.matmul(p.to(vh.dtype).float(),
                                     vf[:, :, j:j + bk])
        if safe:
            l = l + 1e-30
        out[:, :, i0:i1] = (acc / l).to(q.dtype)
    return _merge_heads(out)


def plain_chunked_attention(q, k, v, num_heads: int, *, bk: int = 64,
                            bf16_p: bool = False, block_bytes: int = 1 << 30):
    """T3's function: the running max m (from -1e30) updated per chunk of
    `bk` keys, m_new = max(m, rowmax(s_j)); p = exp2(s_j - m_new) in fp32,
    or of its bf16 rounding with `bf16_p`; corr = exp2(m - m_new);
    l = l * corr + sum p, acc = acc * corr + (p in v's dtype) v; o =
    acc / l. Any `bk` dividing Lk."""
    qs, kh, vh = _heads(q, k, v, num_heads)
    Lk = kh.shape[2]
    bk = _chunk(bk, Lk)
    kt, vf = kh.float().transpose(-1, -2), vh.float()
    out = torch.empty(qs.shape, dtype=q.dtype, device=q.device)
    for i0, i1 in _query_blocks(qs, bk, block_bytes):
        qb = qs[:, :, i0:i1].float()
        m = torch.full(qb.shape[:-1] + (1,), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, device=q.device)
        for j in range(0, Lk, bk):
            s = torch.matmul(qb, kt[..., j:j + bk])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            d = s - m_new
            p = torch.exp2(d.to(torch.bfloat16) if bf16_p else d)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.float().sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(p.to(vh.dtype).float(),
                                            vf[:, :, j:j + bk])
            m = m_new
        out[:, :, i0:i1] = (acc / l).to(q.dtype)
    return _merge_heads(out)


def plain_nomax_unpadded(q, k, v, num_heads: int, *,
                         shift: float = DEFAULT_SHIFT,
                         block_bytes: int = 1 << 30):
    """T5's function: T2 with `safe` and an fp32 p (also the JAX package's
    served K2 softmax, ops/flash_attention.py _attn_kernel nomax)."""
    return plain_nomax_attention(q, k, v, num_heads, shift=shift, safe=True,
                                 block_bytes=block_bytes)


def plain_pvt_attention(q, k, v, num_heads: int, *,
                        shift: float = DEFAULT_SHIFT,
                        block_bytes: int = 1 << 30):
    """T9's function: T5's s, clamp, p and l, but P V takes the fp32 p
    against v upcast to fp32 (the TPU kernel's dot_general(v, e) promotes
    v to e's type), computed as o^T = v^T p^T."""
    qs, kh, vh = _heads(q, k, v, num_heads)
    Lk = kh.shape[2]
    kt, vt = kh.float().transpose(-1, -2), vh.float().transpose(-1, -2)
    out = torch.empty(qs.shape, dtype=q.dtype, device=q.device)
    for i0, i1 in _query_blocks(qs, Lk, block_bytes):
        s = torch.matmul(qs[:, :, i0:i1].float(), kt)
        e = torch.exp2(torch.clamp_max(s, shift + 88.0) - shift)
        l = e.sum(-1, keepdim=True) + 1e-30
        ot = torch.matmul(vt, e.transpose(-1, -2))  # (B, H, hd, rows)
        out[:, :, i0:i1] = (ot.transpose(-1, -2) / l).to(q.dtype)
    return _merge_heads(out)


# T6, T7 and T8 compute T5's function; only the kernels' mapping of work to
# blocks differs, so their plain versions are T5's under their own names.
plain_nomax_4d = plain_nomax_unpadded
plain_nomax_allheads = plain_nomax_unpadded
plain_nomax_laneslice = plain_nomax_unpadded


def plain_slotted_kernel_call(qh, kh, vh, scale: float, *,
                              exp2_bf16: bool = True,
                              block_bytes: int = 1 << 30):
    """T4's function over (BH, Lq, P) q against (BH, Lk, P) k, v, every
    lane read (zero pad lanes add nothing): q pre-scaled by
    scale*log2(e) and rounded to its dtype; the row-max softmax in base 2,
    exp2 of the bf16-rounded s - m (a bf16 p) with `exp2_bf16`, else of
    the fp32 s - m; p rounded to v's dtype for P V, the row sum in fp32,
    the division after P V. Returns (BH, Lq, P). This is K13's function
    (ops.attention._softmax_pv) with one head an image."""
    o = _softmax_pv(_prescaled(qh, scale)[:, None], kh[:, None], vh[:, None],
                    exp2_bf16, block_bytes)
    return o[:, 0].to(qh.dtype)


def plain_sublane_attention(q, k, v, num_heads: int, *,
                            block_bytes: int = 1 << 30):
    """T1's function, in its kernel's order: q pre-scaled by
    scale*log2(e) and rounded to its dtype; s^T = k q^T (keys x queries)
    in fp32; m and the sum over the keys; e = exp2(s^T - m) in fp32,
    rounded to v's dtype for o^T = v^T e^T (fp32 accumulation); o^T / sum,
    transposed back and rounded once."""
    qs, kh, vh = _heads(q, k, v, num_heads)
    kf, vt = kh.float(), vh.float().transpose(-1, -2)
    out = torch.empty(qs.shape, dtype=q.dtype, device=q.device)
    for i0, i1 in _query_blocks(qs, kh.shape[2], block_bytes):
        st = torch.matmul(kf, qs[:, :, i0:i1].float().transpose(-1, -2))
        e = torch.exp2(st - st.amax(-2, keepdim=True))
        ot = torch.matmul(vt, e.to(vh.dtype).float())  # (B, H, hd, rows)
        out[:, :, i0:i1] = (ot / e.sum(-2, keepdim=True)).transpose(
            -1, -2).to(q.dtype)
    return _merge_heads(out)


def _check_pv(e, v, iters):
    if e.dim() != 3 or v.dim() != 3 or v.shape[:2] != (e.shape[0],
                                                       e.shape[2]):
        raise ValueError(f"pv_product: e (bh, bq, Lk) against v (bh, Lk, "
                         f"hd), got {tuple(e.shape)} and {tuple(v.shape)}")
    if iters < 1:
        raise ValueError(f"pv_product: iters={iters} must be at least 1")


def pv_sm90_plan(bh: int, bq: int, lk: int, hd: int, iters: int,
                 transposed: bool, chunk: int | None = None,
                 ctas: int | None = None) -> dict:
    """The split bf16 T10 launches (mirrors csrc/pv_product_sm90.cu plan):
    `n_q` query tiles of 64 rows an image (`tiles` in all), the key chunk
    halved from 256 while the (tile, chunk) grid stays within one wave of
    the SMs (`chunk` keys, `nk` chunks), then `gc` CTAs a (tile, chunk)
    splitting the passes, as many as fill the wave and at most one pass a
    group, each CTA two pass groups (one a consumer warpgroup; `groups`
    a (tile, chunk)). `nb`: wgmma's N (e v: hd rounded up into 40, 80,
    160) or its m64 tiles of hd (transposed); `acc` fp32 accumulators a
    thread; `smem` bytes: the e block (64 x chunk) and the v block's
    64-column atoms, the mbarrier and flag, 1024 bytes of alignment.
    `work_floats`: the partials (`ws_floats`: one a CTA, its two
    warpgroups' totals added, by tile, chunk and CTA group, then 128
    threads x acc) and one int counter a tile. `chunk` and `ctas` force
    the choices."""
    n_q = -(-bq // PV_ROWS)
    tiles = bh * n_q
    if chunk is None:
        chunk = PV_CHUNKS[-1]
        while chunk > PV_CHUNKS[0] and tiles * -(-lk // (chunk // 2)) \
                <= SM_COUNT:
            chunk //= 2
    nk = -(-lk // chunk)
    gc = ctas or max(1, min((iters + 1) // 2, SM_COUNT // (tiles * nk)))
    if transposed:
        nb = -(-hd // 64)
        acc, v_atoms = 32 * nb, nb
    else:
        nb = 40 if hd <= 40 else 80 if hd <= 80 else 160
        acc, v_atoms = nb // 2, -(-nb // 64)
    ws = tiles * nk * gc * 128 * acc
    return dict(n_q=n_q, chunk=chunk, nk=nk, gc=gc, groups=2 * gc, nb=nb,
                acc=acc, smem=chunk * 128 * (1 + v_atoms) + 16 + 1024,
                tiles=tiles, ctas=tiles * nk * gc, ws_floats=ws,
                work_floats=ws + tiles)


def pv_tma_describable(e, v) -> bool:
    """Whether TMA can read bf16 T10's operands: contiguous, 16-byte
    aligned bases, and e's and v's rows in whole 16 bytes (Lk and hd
    multiples of 8)."""
    return (e.is_contiguous() and v.is_contiguous()
            and e.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
            and e.shape[2] % 8 == 0 and v.shape[2] % 8 == 0)


def plain_pv_product(e, v, *, transposed: bool = False, iters: int = 1):
    """T10's function over (bh, bq, Lk) e and (bh, Lk, hd) v: `iters`
    passes of the product e v, each accumulated in fp32 from zero, summed
    one after the other in fp32 and rounded once to e's dtype: (bh, bq,
    hd). `transposed` computes each pass as (v^T e^T)^T. Every pass gives
    the same bits (the TPU tool's per-pass factor on v, 1 + i*1e-9 rounded
    to v's dtype, is exactly 1 in bf16 and left out), so the product is
    taken once here and added `iters` times."""
    _check_pv(e, v, iters)
    ef, vf = e.float(), v.float()
    if transposed:
        o = torch.matmul(vf.transpose(-1, -2),
                         ef.transpose(-1, -2)).transpose(-1, -2)
    else:
        o = torch.matmul(ef, vf)
    acc = torch.zeros_like(o)
    for _ in range(iters):
        acc += o
    return acc.to(e.dtype).contiguous()


def split_heads(x, num_heads: int):
    """(B, L, h*hd) -> contiguous (B*h, L, hd): one copy pass (the TPU
    tools' split transpose)."""
    b, l, d = x.shape
    return _split_heads(x, num_heads).reshape(b * num_heads, l,
                                              d // num_heads).contiguous()


def merge_heads(x, batch: int):
    """(B*h, L, hd) -> contiguous (B, L, h*hd): one copy pass."""
    bh, l, hd = x.shape
    return _merge_heads(x.reshape(batch, bh // batch, l, hd))


# --- kernels ---


def _check(name, q, k, v, num_heads):
    _check_qkv(name, q, k, v, num_heads)
    if q.shape[-1] // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1] // num_heads} > "
                         f"{MAX_HEAD_DIM} (the kernel keeps 16 x hd fp32 "
                         "outputs per warp in registers)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous")


def _launch(source, symbol, argtypes, q, k, v, out, num_heads, *options):
    """Launches `symbol` of csrc/<source>.cu on (B, Lq, H*hd) q, out and
    (B, Lk, H*hd) k, v with the head entries' leading arguments, then
    `options`, the dtype flag and the stream."""
    B, Lq, D = q.shape
    hd = D // num_heads
    fn = _cuda.function(source, symbol, argtypes)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              num_heads, Lq, k.shape[1], hd, float(hd**-0.5 * _LOG2E),
              *options, int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    _cuda.check(source, symbol, code)
    return out


def _shape_key(q, k, num_heads, *options):
    return (tuple(q.shape), tuple(k.shape), num_heads) + options


def nomax_attention(q, k, v, num_heads: int, *, shift: float = DEFAULT_SHIFT,
                    safe: bool = False, bf16_p: bool = False,
                    bk: int | None = None):
    """T2: no-max attention; kernel on CUDA, plain_nomax_attention on CPU.
    `bk` (a divisor of Lk) sets only the plain version's summation chunks;
    the kernel sums over its own 64-key tiles."""
    _chunk(bk, k.shape[1])
    if q.device.type == "cpu":
        return plain_nomax_attention(q, k, v, num_heads, shift=shift,
                                     safe=safe, bf16_p=bf16_p, bk=bk)
    _check("nomax_attention", q, k, v, num_heads)
    out = _launch("attn_arms", "dtp_nomax_attention", _NOMAX_ARGTYPES, q, k,
                  v, torch.empty_like(q), num_heads, float(shift), int(safe),
                  int(bf16_p))
    nomax_launches.record(_shape_key(q, k, num_heads, bool(safe),
                                     bool(bf16_p)))
    return out


def chunked_attention(q, k, v, num_heads: int, *, bk: int = 64,
                      bf16_p: bool = False):
    """T3: online softmax over chunks of `bk` keys; kernel on CUDA (bk 64
    or 128, its K/V tile), plain_chunked_attention on CPU (any divisor of
    Lk)."""
    _chunk(bk, k.shape[1])
    if q.device.type == "cpu":
        return plain_chunked_attention(q, k, v, num_heads, bk=bk,
                                       bf16_p=bf16_p)
    name = "chunked_attention"
    _check(name, q, k, v, num_heads)
    if bk not in CHUNK_WIDTHS:
        raise ValueError(f"{name}: the kernel's chunk is its K/V tile: bk "
                         f"in {CHUNK_WIDTHS}, got {bk}")
    out = _launch("attn_arms", "dtp_chunked_attention", _CHUNKED_ARGTYPES,
                  q, k, v, torch.empty_like(q), num_heads, int(bk),
                  int(bf16_p))
    chunked_launches.record(_shape_key(q, k, num_heads, int(bk),
                                       bool(bf16_p)))
    return out


def _shift_arm(name, source, counter, q, k, v, num_heads, shift):
    """An entry with T5's arguments, reading (B, L, h*hd) in place."""
    _check(name, q, k, v, num_heads)
    out = _launch(source, f"dtp_{name}", _SHIFT_ARGTYPES, q, k, v,
                  torch.empty_like(q), num_heads, float(shift))
    counter.record(_shape_key(q, k, num_heads))
    return out


def nomax_unpadded(q, k, v, num_heads: int, *, shift: float = DEFAULT_SHIFT):
    """T5: clamped no-max attention, P V over hd unpadded; kernel on CUDA,
    plain_nomax_unpadded on CPU. As the TPU tool does, the heads are split
    into contiguous (B*h, L, hd) copies before the kernel (launched with
    one head) and merged back after it; nomax_4d reads them in place."""
    if q.device.type == "cpu":
        return plain_nomax_unpadded(q, k, v, num_heads, shift=shift)
    _check("nomax_unpadded", q, k, v, num_heads)
    qh, kh, vh = (split_heads(t, num_heads) for t in (q, k, v))
    out = _launch("attn_arms", "dtp_nomax_unpadded", _SHIFT_ARGTYPES, qh, kh,
                  vh, torch.empty_like(qh), 1, float(shift))
    nomax_unpadded_launches.record(_shape_key(q, k, num_heads))
    return merge_heads(out, q.shape[0])


def pvt_attention(q, k, v, num_heads: int, *, shift: float = DEFAULT_SHIFT):
    """T9: T5's softmax with P V transposed and P in fp32; kernel on CUDA,
    plain_pvt_attention on CPU."""
    if q.device.type == "cpu":
        return plain_pvt_attention(q, k, v, num_heads, shift=shift)
    return _shift_arm("pvt_attention", "attn_arms", pvt_launches, q, k, v,
                      num_heads, shift)


def nomax_4d(q, k, v, num_heads: int, *, shift: float = DEFAULT_SHIFT):
    """T6: T5's function with the heads read in place from the (B, L, h,
    hd) view, blocks ordered (b, h, q-block); kernel on CUDA,
    plain_nomax_4d on CPU."""
    if q.device.type == "cpu":
        return plain_nomax_4d(q, k, v, num_heads, shift=shift)
    return _shift_arm("nomax_4d", "attn_layouts", nomax_4d_launches, q, k, v,
                      num_heads, shift)


def nomax_allheads(q, k, v, num_heads: int, *, shift: float = DEFAULT_SHIFT):
    """T7: T5's function with every head of a query tile in one block;
    kernel on CUDA, plain_nomax_allheads on CPU."""
    if q.device.type == "cpu":
        return plain_nomax_allheads(q, k, v, num_heads, shift=shift)
    return _shift_arm("nomax_allheads", "attn_layouts",
                      nomax_allheads_launches, q, k, v, num_heads, shift)


def nomax_laneslice(q, k, v, num_heads: int, *,
                    shift: float = DEFAULT_SHIFT):
    """T8: T5's function with blocks ordered (b, q-block, h), the head
    fastest, each slicing its head's lanes from the packed rows; kernel on
    CUDA, plain_nomax_laneslice on CPU."""
    if q.device.type == "cpu":
        return plain_nomax_laneslice(q, k, v, num_heads, shift=shift)
    return _shift_arm("nomax_laneslice", "attn_layouts",
                      nomax_laneslice_launches, q, k, v, num_heads, shift)


def slotted_kernel_call(qh, kh, vh, scale: float, *, exp2_bf16: bool = True):
    """T4: the row-max softmax over (BH, Lq, P) q against (BH, Lk, P) k, v,
    heads already split and zero-padded (P <= 160, every lane read), with
    the caller's scale (hd**-0.5 of the real head dim); returns (BH, Lq,
    P). Kernel on CUDA: bf16 K13's two-pass wgmma/TMA kernel with H = 1
    and hd = P (csrc/flash_attention_sm90.cu dtp_slotted_attention_sm90,
    its bucket ops.attention.sm90_plan(P, Lq, BH)'s; P a multiple of 8 and
    16-byte-aligned bases, else ValueError), fp32 the FMA twin
    (csrc/attn_layouts.cu). plain_slotted_kernel_call on CPU."""
    if qh.device.type == "cpu":
        return plain_slotted_kernel_call(qh, kh, vh, scale,
                                         exp2_bf16=exp2_bf16)
    name = "slotted_kernel_call"
    _check(name, qh, kh, vh, 1)
    BH, Lq, P = qh.shape
    out = torch.empty_like(qh)
    args = (qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(), BH,
            Lq, kh.shape[1], P, float(scale * _LOG2E), int(exp2_bf16))
    if qh.dtype == torch.bfloat16:
        if P % 8 or any(t.data_ptr() % 16 for t in (qh, kh, vh)):
            raise ValueError(f"{name}: TMA needs P a multiple of 8 and "
                             f"16-byte-aligned bases, got P {P}")
        source, symbol = SM90_SOURCE, "dtp_slotted_attention_sm90"
        fn = _cuda.function(source, symbol, _SLOTTED_SM90_ARGTYPES)
        code = fn(*args, _cuda.stream_of(qh))
    else:
        source, symbol = "attn_layouts", "dtp_slotted_attention"
        fn = _cuda.function(source, symbol, _SLOTTED_ARGTYPES)
        code = fn(*args, 0, _cuda.stream_of(qh))
    _cuda.check(source, symbol, code)
    slotted_launches.record((tuple(qh.shape), tuple(kh.shape),
                             bool(exp2_bf16)))
    return out


def sublane_attention(q, k, v, num_heads: int):
    """T1: the exact row-max softmax with both products transposed
    (S^T = K Q^T, O^T = V^T E^T); kernel on CUDA,
    plain_sublane_attention on CPU."""
    if q.device.type == "cpu":
        return plain_sublane_attention(q, k, v, num_heads)
    _check("sublane_attention", q, k, v, num_heads)
    out = _launch("attn_transposed", "dtp_sublane_attention",
                  _SUBLANE_ARGTYPES, q, k, v, torch.empty_like(q), num_heads)
    sublane_launches.record(_shape_key(q, k, num_heads))
    return out


def pv_product(e, v, *, transposed: bool = False, iters: int = 1):
    """T10: `iters` passes of the product of (bh, bq, Lk) e and (bh, Lk,
    hd) v, as e v or as (v^T e^T)^T, summed in fp32: (bh, bq, hd) in e's
    dtype. Kernel on CUDA (hd <= 160): bf16 a split wgmma/TMA GEMM whose
    operands stay in shared memory for all passes (csrc/pv_product_sm90.cu,
    pv_sm90_plan; Lk and hd multiples of 8 and 16-byte-aligned bases, else
    ValueError), fp32 the FMA twin (csrc/attn_transposed.cu).
    plain_pv_product on CPU."""
    if e.device.type == "cpu":
        return plain_pv_product(e, v, transposed=transposed, iters=iters)
    return _pv_product(e, v, transposed, iters)


def _pv_product(e, v, transposed: bool, iters: int, chunk=None, ctas=None):
    """pv_product on CUDA; `chunk` and `ctas` force bf16's split (probes:
    pv_sm90_plan)."""
    _check_pv(e, v, iters)
    name = "pv_product"
    if e.dtype not in (torch.bfloat16, torch.float32) or v.dtype != e.dtype:
        raise TypeError(f"{name}: e and v must share bf16 or fp32, got "
                        f"{e.dtype} and {v.dtype}")
    if v.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: hd {v.shape[2]} > {MAX_HEAD_DIM}")
    if v.device != e.device or not (e.is_contiguous()
                                    and v.is_contiguous()):
        raise ValueError(f"{name}: e and v must be contiguous on {e.device}")
    bh, bq, lk = e.shape
    hd = v.shape[2]
    if e.dtype == torch.bfloat16 and not pv_tma_describable(e, v):
        raise ValueError(f"{name}: TMA needs Lk and hd multiples of 8 and "
                         f"16-byte-aligned bases, got Lk {lk}, hd {hd}")
    out = torch.empty((bh, bq, hd), dtype=e.dtype, device=e.device)
    if e.dtype == torch.bfloat16:
        plan = pv_sm90_plan(bh, bq, lk, hd, iters, transposed, chunk, ctas)
        work = torch.empty(plan["work_floats"], dtype=torch.float32,
                           device=e.device)
        source, symbol = PV_SM90_SOURCE, "dtp_pv_product_sm90"
        fn = _cuda.function(source, symbol, _PV_SM90_ARGTYPES)
        code = fn(e.data_ptr(), v.data_ptr(), out.data_ptr(),
                  work.data_ptr(), work.numel(), bh, bq, lk, hd, int(iters),
                  int(transposed), chunk or 0, ctas or 0, _cuda.stream_of(e))
    else:
        source, symbol = "attn_transposed", "dtp_pv_product"
        fn = _cuda.function(source, symbol, _PV_ARGTYPES)
        code = fn(e.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bq, lk,
                  hd, int(iters), int(transposed), 0, _cuda.stream_of(e))
    _cuda.check(source, symbol, code)
    pv_product_launches.record((tuple(e.shape), tuple(v.shape),
                                bool(transposed), int(iters)))
    return out


# name -> (wrapper, plain version), for the entry point and the smoke; the
# (B, L, h*hd) arms take (q, k, v, num_heads), T4 (qh, kh, vh, scale)
ARMS = {
    "nomax_attention": (nomax_attention, plain_nomax_attention),
    "chunked_attention": (chunked_attention, plain_chunked_attention),
    "nomax_unpadded": (nomax_unpadded, plain_nomax_unpadded),
    "pvt_attention": (pvt_attention, plain_pvt_attention),
    "nomax_4d": (nomax_4d, plain_nomax_4d),
    "nomax_allheads": (nomax_allheads, plain_nomax_allheads),
    "nomax_laneslice": (nomax_laneslice, plain_nomax_laneslice),
    "slotted_kernel_call": (slotted_kernel_call, plain_slotted_kernel_call),
    "sublane_attention": (sublane_attention, plain_sublane_attention),
}
# name -> its wrapper's launch counter
LAUNCHES = {c.name: c for c in (
    nomax_launches, chunked_launches, nomax_unpadded_launches, pvt_launches,
    nomax_4d_launches, nomax_allheads_launches, nomax_laneslice_launches,
    slotted_launches, sublane_launches, pv_product_launches)}
