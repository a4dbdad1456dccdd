"""bf16 K12b (upsample2x_conv3x3_inpad, upsample2x_conv3x3 under the
port's _IN_PAD switch) on K4's kernel, and bf16 T11 (conv_window_taps) as
one row-shifted wgmma/TMA GEMM (csrc/window_taps_sm90.cu).

K12b computes K4's function: it launches dtp_upsample2x_conv3x3_sm90 of
csrc/gn_conv_sm90.cu with K4's plan (TMA's out-of-bounds zeros are its
on-chip padding) and counts on its own counter; fp32 stays on
csrc/conv_staged.cu's staged-tile UP mode. T11's four tap reads are one
function of a base row and a pitch over a window's flat rows, and its
kernel reads three TMA boxes a chunk (one a di) at row offset dj; fp32
stays on csrc/conv_arms.cu.

On the CPU, the host logic that needs no card: the dispatch through a
patched `_cuda.function` (bf16 K12b reaches dtp_upsample2x_conv3x3_sm90
with upconv_sm90_plan's arguments, fp32 dtp_upsample2x_conv3x3_staged;
each call moves its own counter only; _IN_PAD routes upsample2x_conv3x3 to
K12b; bf16 refuses what TMA cannot describe; bf16 T11 reaches
dtp_conv_window_taps_sm90 with taps_sm90_plan's arguments, an N off 8
zero-padded, a Cin off 8 refused, fp32 dtp_conv_window_taps), T11's plan
at the conv_arms path's and the TPU tool's shapes, and a torch emulation
of T11's kernel reads (three boxes a chunk, row offset dj, the pitch, the
split order and the carry) against the JAX tool's _kernel in interpret
mode and against plain_conv_window_taps. JAX is imported inside those
tests only: the card's machine has none.

Marked `cuda` (skipped without a card; on the card:
python -m pytest -m cuda --noconftest
tests/test_torch_port_upconv_inpad_taps_sm90.py): K12b equal to K4 bit for
bit at the twin's upsample shapes and ragged ones, T11 against its plain
version at every read at the conv_arms, tool and ragged shapes, forced
tiles and splits, replays bit-identical, refusals that launch nothing, the
fp32 entries refusing bf16, the Python plan equal to the library's.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import conv3x3, gn_conv
from diffusiontexturepainting_torch.ops import conv_variants as cv
from diffusiontexturepainting_torch.tools import kernel_ab

torch.set_num_threads(2)

TAPS_CU = _cuda.CSRC / "window_taps_sm90.cu"
# (B, H, W, C): K12b at the safe twin's 256^2 K4 shapes (15 launches a
# stamp over these six)
TWIN_UP = [s[:4] for s in kernel_ab.TWIN_K4]
# (B, H, W, Cin, Cout) TMA can describe: odd H and W, a 1x1 image, Cout
# 40, 136 and 8 off the 128-column tile, Cin off the 64-channel chunk
UP_RAGGED = [(1, 7, 5, 8, 40), (2, 3, 9, 16, 24), (1, 1, 1, 48, 136),
             (2, 11, 19, 48, 8), (1, 6, 5, 48, 40)]
UP_REFUSED = [(1, 4, 4, 20, 16), (1, 4, 4, 16, 12)]
UP_COUNTERS = (conv3x3.upsample_launches, conv3x3.upsample_inpad_launches)
# (nwin, H_T, W, Cin, N, reps): the conv_arms path's windows (reps 1) and
# the TPU tool's shapes (one window, reps 24)
TAPS_ARMS = [s[:5] + (1,) for s in kernel_ab.TAPS_ARMS]
TAPS_TOOL = list(kernel_ab.TAPS_TOOL)
# ragged windows TMA can describe: odd rows and widths, Cin 8 and 48, N
# off 8 and off the tile, several windows, one row
TAPS_RAGGED = [(2, 7, 5, 8, 40, 3), (3, 5, 9, 16, 3, 1),
               (2, 3, 19, 40, 130, 1), (1, 11, 19, 48, 8, 2),
               (4, 1, 30, 72, 24, 3)]
READS = cv.VARIANTS


def _wp(W):
    return W + 2 + (-(W + 2)) % 8


class _FakeCuda:
    """What the wrappers read of a CUDA tensor, on a machine without one."""

    def __init__(self, shape, dtype, ptr=1 << 20):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self.ptr = ptr

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def view(self, *shape):
        return _FakeCuda(shape, self.dtype, self.ptr)


def _patch(monkeypatch):
    """A stub of _cuda.function recording (source, symbol, args), fake CUDA
    tensors from torch.empty, and F.pad of a fake tensor giving a fake
    tensor of the padded shape at another address."""
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 0
        return call

    def empty(shape, dtype=None, device=None, **_):
        shape = (shape,) if isinstance(shape, int) else shape
        return _FakeCuda(shape, dtype)

    pad = F.pad

    def fake_pad(t, widths, *a, **k):
        if not isinstance(t, _FakeCuda):
            return pad(t, widths, *a, **k)
        shape = list(t.shape)
        for i in range(len(widths) // 2):
            shape[-1 - i] += widths[2 * i] + widths[2 * i + 1]
        return _FakeCuda(shape, t.dtype, 2 << 20)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(F, "pad", fake_pad)
    return calls


# --- K12b on the CPU ---


@pytest.mark.parametrize("shape", TWIN_UP + [UP_RAGGED[2]], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k12b_dispatch(monkeypatch, dtype, shape):
    """bf16 K12b reaches dtp_upsample2x_conv3x3_sm90 of gn_conv_sm90.cu with
    upconv_sm90_plan's arguments (a work buffer exactly where the plan
    splits K; the plan's split, not forced), fp32 the staged-tile UP mode
    dtp_upsample2x_conv3x3_staged with is_bf16 0; the call moves K12b's
    counter by one and K4's not at all."""
    calls = _patch(monkeypatch)
    B, H, W, cin = shape[:4]
    cout = shape[4] if len(shape) > 4 else cin
    x = _FakeCuda((B, H, W, cin), dtype)
    w = _FakeCuda((3, 3, cin, cout), dtype)
    taps = _FakeCuda((16, cin, cout), dtype)
    b = _FakeCuda((cout,), dtype)
    before = [c.launches for c in UP_COUNTERS]
    out = conv3x3.upsample2x_conv3x3_inpad(x, w, b, taps)
    assert out.shape == (B, 2 * H, 2 * W, cout) and out.dtype == dtype
    assert [c.launches - n for c, n in zip(UP_COUNTERS, before)] == [0, 1]
    assert conv3x3.upsample_inpad_launches.shapes[
        ((B, H, W, cin), (3, 3, cin, cout))] >= 1
    assert len(calls) == 1
    source, symbol, args = calls[0]
    if dtype == torch.bfloat16:
        assert (source, symbol) == ("gn_conv_sm90",
                                    "dtp_upsample2x_conv3x3_sm90")
        plan = gn_conv.upconv_sm90_plan(B, H, W, cin, cout)
        assert (args[4] is not None) == (plan["splits"] > 1)
        assert args[5:11] == (B, H, W, cin, cout, 0)
    else:
        assert (source, symbol) == ("conv_staged",
                                    "dtp_upsample2x_conv3x3_staged")
        assert args[4:10] == (B, H, W, cin, cout, 0)


def test_in_pad_routes_upsample_to_k12b(monkeypatch):
    """upsample2x_conv3x3 of a bf16 CUDA tensor under _IN_PAD takes K12b's
    counter and K4's launch with the same arguments; with the switch off,
    K4's counter and the same launch."""
    calls = _patch(monkeypatch)
    x = _FakeCuda((3, 8, 8, 1280), torch.bfloat16)
    w = _FakeCuda((3, 3, 1280, 1280), torch.bfloat16)
    taps = _FakeCuda((16, 1280, 1280), torch.bfloat16)
    b = _FakeCuda((1280,), torch.bfloat16)
    seen = []
    for on in (True, False):
        before = [c.launches for c in UP_COUNTERS]
        monkeypatch.setattr(conv3x3, "_IN_PAD", on)
        conv3x3.upsample2x_conv3x3(x, w, b, taps)
        seen.append([c.launches - n for c, n in zip(UP_COUNTERS, before)])
    assert seen == [[0, 1], [1, 0]]
    assert calls[0][1:] == calls[1][1:]
    assert calls[0][1] == "dtp_upsample2x_conv3x3_sm90"


@pytest.mark.parametrize("shape", UP_REFUSED, ids=str)
def test_k12b_bf16_refuses_what_tma_cannot_describe(monkeypatch, shape):
    """bf16 K12b at Cin 20 and Cout 12 (and on a base 2 bytes off 16)
    raises ValueError before any launch and moves no counter; fp32 runs
    the staged twin there. The staged UP entry refuses bf16."""
    calls = _patch(monkeypatch)
    B, H, W, cin, cout = shape
    before = [c.launches for c in UP_COUNTERS]
    for ptr in (1 << 20, (1 << 20) + 2):
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.upsample2x_conv3x3_inpad(
                _FakeCuda((B, H, W, cin), torch.bfloat16, ptr),
                _FakeCuda((3, 3, cin, cout), torch.bfloat16),
                None, _FakeCuda((16, cin, cout), torch.bfloat16))
    with pytest.raises(ValueError, match="TMA"):
        conv3x3.upsample2x_conv3x3_inpad(
            _FakeCuda((1, 4, 4, 16), torch.bfloat16, (1 << 20) + 2),
            _FakeCuda((3, 3, 16, 16), torch.bfloat16), None,
            _FakeCuda((16, 16, 16), torch.bfloat16))
    assert calls == [] and [c.launches for c in UP_COUNTERS] == before
    conv3x3.upsample2x_conv3x3_inpad(
        _FakeCuda((B, H, W, cin), torch.float32),
        _FakeCuda((3, 3, cin, cout), torch.float32), None,
        _FakeCuda((16, cin, cout), torch.float32))
    assert [c[1] for c in calls] == ["dtp_upsample2x_conv3x3_staged"]
    src = (_cuda.CSRC / "conv_staged.cu").read_text()
    assert "if (is_bf16) return cudaErrorInvalidValue;" in src


# --- T11 on the CPU ---


def _taps_fakes(nwin, h_t, W, cin, n, read, dtype=torch.bfloat16, ptr=None):
    wp = _wp(W)
    xwin = _FakeCuda((nwin, h_t + 2, wp, cin), dtype,
                     *(() if ptr is None else (ptr,)))
    w = _FakeCuda((3, 3 * cin, n) if read == "jointw" else (9, cin, n),
                  dtype, 3 << 20)
    return xwin, w, wp


@pytest.mark.parametrize("shape", [TAPS_ARMS[0], TAPS_ARMS[6], TAPS_TOOL[0],
                                   TAPS_RAGGED[1]], ids=str)
@pytest.mark.parametrize("read", READS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_taps_dispatch(monkeypatch, dtype, read, shape):
    """bf16 T11 reaches dtp_conv_window_taps_sm90 of window_taps_sm90.cu
    with taps_sm90_plan's arguments (a work buffer exactly where the plan
    splits K; N padded up to 8 and the real N stored), fp32
    dtp_conv_window_taps of conv_arms.cu with is_bf16 0; one count."""
    calls = _patch(monkeypatch)
    nwin, h_t, W, cin, n, reps = shape
    xwin, w, wp = _taps_fakes(nwin, h_t, W, cin, n, read, dtype)
    before = cv.conv_window_taps_launches.launches
    out = cv.conv_window_taps(xwin, w, read, W=W, reps=reps)
    assert out.shape == (nwin, h_t, W, n) and out.dtype == dtype
    assert cv.conv_window_taps_launches.launches == before + 1
    assert len(calls) == 1
    source, symbol, args = calls[0]
    if dtype == torch.bfloat16:
        n8 = n + (-n % 8)
        assert (source, symbol) == ("window_taps_sm90",
                                    "dtp_conv_window_taps_sm90")
        plan = gn_conv.taps_sm90_plan(nwin, h_t, W, wp, cin, n8, read)
        assert (args[3] is not None) == (plan["splits"] > 1)
        assert args[1] == (w.ptr if n8 == n else 2 << 20)  # padded copy
        assert args[4:15] == (nwin, h_t, W, wp, cin, n8, n,
                              READS.index(read), reps, 0, 0)
    else:
        assert (source, symbol) == ("conv_arms", "dtp_conv_window_taps")
        assert args[3:12] == (nwin, h_t, W, wp, cin, n, READS.index(read),
                              reps, 0)


@pytest.mark.parametrize("cin", [3, 9, 20])
def test_taps_bf16_refuses_cin_off_8(monkeypatch, cin):
    """bf16 T11 at Cin 3, 9, 20 (rows of 6, 18, 40 bytes) and on a window 2
    bytes off 16 raises ValueError before any launch and moves no count;
    fp32 runs conv_arms.cu's twin there."""
    calls = _patch(monkeypatch)
    before = cv.conv_window_taps_launches.launches
    for read in READS:
        xwin, w, _ = _taps_fakes(2, 5, 9, cin, 40, read)
        with pytest.raises(ValueError, match="TMA"):
            cv.conv_window_taps(xwin, w, read, W=9, reps=3)
    xwin, w, _ = _taps_fakes(2, 5, 9, 16, 40, "shifted", ptr=(1 << 20) + 2)
    with pytest.raises(ValueError, match="TMA"):
        cv.conv_window_taps(xwin, w, "shifted", W=9)
    assert calls == [] and cv.conv_window_taps_launches.launches == before
    xwin, w, _ = _taps_fakes(2, 5, 9, cin, 40, "rowflat", torch.float32)
    cv.conv_window_taps(xwin, w, "rowflat", W=9)
    assert [c[1] for c in calls] == ["dtp_conv_window_taps"]
    src = (_cuda.CSRC / "conv_arms.cu").read_text()
    entry = src[src.index('extern "C" cudaError_t dtp_conv_window_taps('):]
    assert "if (is_bf16 ||" in entry[:entry.index("\n}\n")]


def _bases(read, wp):
    """base(di, 0) of each di's box and the dj step (the source's
    tap_bases)."""
    if read == "unshifted":
        return (0, 0, 0), 0
    if read == "jointw":
        return tuple(min(di * wp, 2 * wp - 2) for di in range(3)), 1
    return tuple(di * wp for di in range(3)), 1


@pytest.mark.parametrize("shape", TAPS_ARMS + TAPS_TOOL + TAPS_RAGGED,
                         ids=str)
@pytest.mark.parametrize("read", READS)
def test_taps_plan_covers_every_stored_output_once(shape, read):
    """The tiles of a window (tiles never cross one: tr output rows of tw
    columns, tw a power of two from 16 that holds W where the tile's
    pixels allow) cover every stored output once, the N tiles N, the
    splits the channel chunks once; every stored output's tap reads lie
    inside its window (rows past it arrive as zeros and feed only outputs
    that are not stored); each TMA box is at most 256 rows; shared memory
    within the H100's 232,448 bytes a block, with at least two B stages;
    the grid within CUDA's limits; the tool's single window fills half of
    the SMs or more."""
    nwin, h_t, W, cin, n, _ = shape
    n8 = n + (-n % 8)
    wp = _wp(W)
    for consumers, splits in ((None, None), (1, 1), (2, 3)):
        p = gn_conv.taps_sm90_plan(nwin, h_t, W, wp, cin, n8, read,
                                   consumers, splits)
        rows = 64 * p["consumers"]
        assert p["tw"] * p["tr"] == rows and p["tw"] >= 16
        assert p["tw"] & (p["tw"] - 1) == 0
        assert p["tw"] >= W or p["tw"] == rows
        covered = [(t // p["x_tiles"] * p["tr"] + k,
                    t % p["x_tiles"] * p["tw"] + x)
                   for t in range(p["tiles_win"]) for k in range(p["tr"])
                   for x in range(p["tw"])]
        stored = [(h, x) for h in range(h_t) for x in range(W)]
        assert sorted(c for c in covered if c[0] < h_t and c[1] < W) == stored
        assert p["tiles_win"] == p["h_tiles"] * p["x_tiles"]
        assert p["m_tiles"] == nwin * p["tiles_win"] <= 65535
        assert (p["n_tiles"] - 1) * 128 < n8 <= p["n_tiles"] * 128
        assert p["splits"] * p["per_split"] >= p["chunks"] > (
            (p["splits"] - 1) * p["per_split"])
        assert p["chunks"] == -(-cin // 64)
        assert p["box_rows"] == p["tw"] + 2 <= 256
        assert p["nbox"] == (1 if read == "unshifted" else 3)
        assert p["smem"] <= gn_conv.SMEM_LIMIT and p["stages"] >= 2
        assert p["work_floats"] == (
            0 if p["splits"] == 1 else p["m_tiles"] * p["n_tiles"] * (
                p["splits"] * rows * 128 + 1))
        box, step = _bases(read, wp)
        last = (h_t - 1) * p["pitch"] + W - 1
        assert max(box) + 2 * step + last < (h_t + 2) * wp
    p = gn_conv.taps_sm90_plan(nwin, h_t, W, wp, cin, n8, read)
    if shape in TAPS_TOOL:
        assert p["m_tiles"] * p["n_tiles"] * p["splits"] >= (
            gn_conv.SM_COUNT // 2)


def test_taps_plan_matches_the_source():
    """taps_sm90_plan mirrors the source's constants and rules."""
    text = TAPS_CU.read_text()
    for const in (f"kAStages = {gn_conv.TAPS_A_STAGES};",
                  f"kMaxBStages = {gn_conv.TAPS_MAX_B_STAGES};",
                  f"constexpr int kTail = 16 + 32;",
                  "p.pitch = read == kRowflat ? W : Wp;",
                  "while (p.tw < W && p.tw < rows) p.tw *= 2;",
                  "p.tr = rows / p.tw;",
                  "p.nbox = read == kUnshifted ? 1 : 3;",
                  "p.box_rows = p.tw + 2;",
                  "const int a_stages = kAStages * p.tr * p.nbox * p.box_bytes;",
                  "p.region0 + 8 * 2 * (kAStages + kMaxBStages) + kTail + 1024;",
                  "2LL * p.m_tiles * p.n_tiles >= kSMs",
                  "blocks >= kSMs ? 1 : kSMs / blocks"):
        assert const in text, const
    assert gn_conv.TAPS_TAIL == 16 + 32
    assert gn_conv.TAPS_SM90_SOURCE in _cuda.SOURCES


def _emulate_taps(xwin, w, read, W, reps=1, consumers=None, splits=None):
    """The kernel's reads in torch (fp32), for xwin (nwin, H_T+2, Wp, Cin)
    and w (9, Cin, N): for each tile of the plan (tr output rows of tw
    columns of one window) and each 64-channel chunk of its split, each
    segment k's boxes of tw + 2 flat rows at base(di, 0) + (h0 + k) *
    pitch + x0 (rows past the window zero, as TMA's out-of-bounds rows);
    tap (di, dj) of segment k reads its box di (box 0 for unshifted) at
    row offset dj * step; each split accumulates its chunks, the splits
    added in split order; + the carry, (reps - 1) times acc[0, 0, 0] of
    the window, added one after the other; one rounding to xwin's dtype;
    the outputs with h < H_T and x < W stored."""
    nwin, rows_in, wp, cin = xwin.shape
    h_t, n = rows_in - 2, w.shape[-1]
    w9 = w.float().reshape(9, cin, n)
    p = gn_conv.taps_sm90_plan(nwin, h_t, W, wp, cin, n, read, consumers,
                               splits)
    tw, tr, pitch = p["tw"], p["tr"], p["pitch"]
    box, step = _bases(read, wp)
    out = torch.empty((nwin, h_t, W, n), dtype=xwin.dtype)
    for wi in range(nwin):
        flat = xwin[wi].float().reshape(-1, cin)
        flat = F.pad(flat, (0, 0, 0, p["h_tiles"] * tr * pitch + 2 * wp
                            + 2 * tw))
        first = sum(flat[box[k // 3] + (k % 3) * step] @ w9[k, :, 0]
                    for k in range(9))
        carry = torch.zeros(())
        for _ in range(reps - 1):
            carry = carry + first
        for t in range(p["tiles_win"]):
            h0 = t // p["x_tiles"] * tr
            x0 = t % p["x_tiles"] * tw
            parts = []
            for s in range(p["splits"]):
                acc = torch.zeros((tr * tw, n))
                for c in range(s * p["per_split"],
                               min((s + 1) * p["per_split"], p["chunks"])):
                    c0, c1 = 64 * c, min(64 * c + 64, cin)
                    for k in range(tr):
                        start = (h0 + k) * pitch + x0
                        boxes = [flat[b + start:b + start + tw + 2, c0:c1]
                                 for b in box]
                        for tap in range(9):
                            di, dj = divmod(tap, 3)
                            a = boxes[di][dj * step:dj * step + tw]
                            acc[k * tw:(k + 1) * tw] += a @ w9[tap, c0:c1]
                parts.append(acc)
            vals = (functools.reduce(torch.add, parts) + carry).to(
                xwin.dtype)
            for r in range(tr * tw):
                h, x = h0 + r // tw, x0 + r % tw
                if h < h_t and x < W:
                    out[wi, h, x] = vals[r]
    return out


def _taps_np(nwin, h_t, W, cin, n, read, seed):
    rng = np.random.default_rng(seed)
    xwin = rng.random((nwin, h_t + 2, _wp(W), cin)).astype(np.float32)
    w = rng.random((9, cin, n)).astype(np.float32)
    return xwin, w


@pytest.mark.parametrize("read", READS)
@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("shape,consumers,splits", [
    ((2, 6, 14, 80, 8), None, None), ((1, 6, 14, 80, 8), 1, 2),
    ((1, 5, 9, 16, 24), 2, None), ((1, 3, 70, 16, 8), 1, None)], ids=str)
def test_emulated_reads_match_tool_and_plain(shape, consumers, splits, read,
                                             reps):
    """The emulated kernel reads (tiles of tr output rows of tw columns,
    ragged in H and in W, three boxes a segment at row offset dj, the
    pitch, the splits in order, the carry) and the port's conv_window_taps (plain on the CPU) against the
    JAX tool's _kernel in interpret mode, window by window, and against
    plain_conv_window_taps: fp32, within 1e-5 of the output's peak
    (summation order)."""
    from tests import test_torch_port_conv_arms as arms

    nwin, h_t, W, cin, n = shape
    xwin, w = _taps_np(nwin, h_t, W, cin, n, read, 7 + reps)
    wv = w.reshape(3, 3 * cin, n) if read == "jointw" else w
    tx, tw = torch.from_numpy(xwin), torch.from_numpy(wv)
    got = _emulate_taps(tx, tw, read, W, reps, consumers, splits)
    plain = cv.plain_conv_window_taps(tx, tw, read, W=W, reps=reps)
    wrapper = cv.conv_window_taps(tx, tw, read, W=W, reps=reps)
    peak = plain.abs().max().item()
    for other in (plain, wrapper):
        torch.testing.assert_close(got, other, atol=1e-5 * peak, rtol=0)
    import jax.numpy as jnp

    for i in range(nwin):
        tool = arms._jax_taps(jnp.asarray(xwin[i]), jnp.asarray(wv), read,
                              W, reps)
        np.testing.assert_allclose(got[i].numpy(), tool, atol=1e-5 * peak,
                                   rtol=0)


def test_emulated_shifted_reads_the_valid_conv():
    """`shifted` through the emulated reads is F.conv2d (VALID) of the
    window: the boxes' row offsets are the conv's taps."""
    xwin, w = _taps_np(2, 6, 14, 24, 16, "shifted", 3)
    tx, tw = torch.from_numpy(xwin), torch.from_numpy(w)
    got = _emulate_taps(tx, tw, "shifted", 14, consumers=1, splits=1)
    conv = F.conv2d(tx[:, :, :16].permute(0, 3, 1, 2),
                    tw.view(3, 3, 24, 16).permute(3, 2, 0, 1))
    torch.testing.assert_close(got, conv.permute(0, 2, 3, 1), atol=1e-4,
                               rtol=1e-5)


def test_plans_entry_point_runs_taps_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows taps on the CPU: the wrapper's plain
    route for each read, nothing timed."""
    import json

    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "taps"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["tag"].split()[-1] for r in record["rows"]] == list(READS) * 2
    assert all(r["plan"] and r["ms"] is None and r["max_diff"] == 0.0
               for r in record["rows"])


def test_kernel_ab_sums_a_stamp():
    """kernel_ab's stamp sums weight each row by its launches a stamp and
    leave the tool's rows out."""
    rows = [{"kernel": "K12b", "tag": "twin 4^2 1280", "count": 4,
             "ms": 0.5, "device_ms": 0.25},
            {"kernel": "K12b", "tag": "twin 8^2 1280", "count": 1,
             "ms": 1.0, "device_ms": 0.5},
            {"kernel": "T11", "tag": "conv_arms jointw 4x8x32", "count": 10,
             "ms": 0.1, "device_ms": 0.05},
            {"kernel": "T11", "tag": "tool jointw 1x16x128", "count": 1,
             "ms": 9.0, "device_ms": 9.0},
            {"kernel": "K3", "tag": "256^2 UNet level 0", "ms": 1.0,
             "device_ms": 1.0}]
    assert kernel_ab.stamp_sums(rows) == {"K12b": (3.0, 1.5),
                                          "T11 jointw": (1.0, 0.5)}
    assert sum(s[-1] for s in kernel_ab.TAPS_ARMS) == 50
    assert sum(s[-1] for s in kernel_ab.TWIN_K4) == 15


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _up_inputs(gen, B, H, W, cin, cout):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(B, H, W, cin).bfloat16()
    w = (rnd(3, 3, cin, cout) * (9 * cin) ** -0.5).bfloat16()
    return x, w, (rnd(cout) * 0.1).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s + (s[3],) for s in TWIN_UP] + UP_RAGGED,
                         ids=str)
def test_sm90_k12b_equals_k4(shape):
    """bf16 K12b against upsample2x_conv3x3_plain (chip_smoke's tolerance:
    2^-5 of the largest output magnitude), equal bit for bit to K4 on the
    same inputs, replayed bit for bit; one launch on K12b's counter."""
    gen = _setup()
    x, w, b = _up_inputs(gen, *shape)
    taps = conv3x3.fold_upsample_weights(w)
    before = [c.launches for c in UP_COUNTERS]
    got = conv3x3.upsample2x_conv3x3_inpad(x, w, b, taps)
    assert [c.launches - n for c, n in zip(UP_COUNTERS, before)] == [0, 1]
    again = conv3x3.upsample2x_conv3x3_inpad(x, w, b, taps)
    k4 = conv3x3._upsample2x_conv3x3(x, b, taps)
    want = conv3x3.upsample2x_conv3x3_plain(x, w, b).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() <= (
        2.0**-5 * want.abs().max().item())
    assert torch.equal(got, k4) and torch.equal(got, again)


def _taps_case(gen, nwin, h_t, W, cin, n, read):
    wp = _wp(W)
    xwin = torch.rand((nwin, h_t + 2, wp, cin), generator=gen,
                      device="cuda").bfloat16()
    w = torch.rand((9, cin, n), generator=gen, device="cuda").bfloat16()
    return xwin, (w.view(3, 3 * cin, n) if read == "jointw" else w)


def _hold(got, want):
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0**-5 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TAPS_ARMS + TAPS_TOOL + TAPS_RAGGED,
                         ids=str)
@pytest.mark.parametrize("read", READS)
def test_sm90_taps_match_plain(shape, read):
    """bf16 T11 against plain_conv_window_taps (2^-5 of the largest output
    magnitude) at the conv_arms path's windows, the tool's shapes (reps
    24) and ragged ones, replayed bit for bit; one count a call."""
    gen = _setup()
    nwin, h_t, W, cin, n, reps = shape
    xwin, w = _taps_case(gen, nwin, h_t, W, cin, n, read)
    before = cv.conv_window_taps_launches.launches
    got = cv.conv_window_taps(xwin, w, read, W=W, reps=reps)
    again = cv.conv_window_taps(xwin, w, read, W=W, reps=reps)
    want = cv.plain_conv_window_taps(xwin, w, read, W=W, reps=reps)
    torch.cuda.synchronize()
    assert cv.conv_window_taps_launches.launches == before + 2
    assert got.shape == (nwin, h_t, W, n)
    _hold(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [TAPS_ARMS[5], TAPS_TOOL[0],
                                   TAPS_RAGGED[2]], ids=str)
@pytest.mark.parametrize("read", ["shifted", "jointw"])
def test_sm90_taps_forced_tiles_and_splits(shape, read):
    """Every forced tile (one or two consumer warpgroups) and split of K
    gives its plain version's result, each replayed bit for bit."""
    gen = _setup()
    nwin, h_t, W, cin, n, reps = shape
    xwin, w = _taps_case(gen, nwin, h_t, W, cin, n, read)
    want = cv.plain_conv_window_taps(xwin, w, read, W=W, reps=reps)
    for nc in (1, 2):
        for splits in (1, 2, 3):
            call = functools.partial(cv._conv_window_taps, xwin, w, read,
                                     W=W, reps=reps, consumers=nc,
                                     splits=splits)
            got, again = call(), call()
            torch.cuda.synchronize()
            _hold(got, want)
            assert torch.equal(got, again), (nc, splits)


@pytest.mark.cuda
def test_sm90_taps_shifted_is_the_conv():
    """`shifted` on an image's row windows with halo is F.conv2d (VALID,
    fp32) of the windows within bf16's tolerance."""
    gen = _setup()
    xwin, w = _taps_case(gen, 8, 8, 32, 512, 512, "shifted")
    got = cv.conv_window_taps(xwin, w, "shifted", W=32)
    conv = F.conv2d(xwin[:, :, :34].float().permute(0, 3, 1, 2),
                    w.float().view(3, 3, 512, 512).permute(3, 2, 0, 1))
    _hold(got, conv.permute(0, 2, 3, 1))


@pytest.mark.cuda
def test_sm90_refusals_launch_nothing():
    """bf16 T11 at Cin 3 and bf16 K12b at Cin 20 raise ValueError and launch
    nothing; conv_arms.cu's T11 entry and conv_staged.cu's UP entry refuse
    bf16 (cudaErrorInvalidValue)."""
    gen = _setup()
    x3 = torch.rand((2, 7, 16, 3), generator=gen, device="cuda").bfloat16()
    w3 = torch.rand((9, 3, 40), generator=gen, device="cuda").bfloat16()
    x20 = torch.rand((1, 4, 4, 20), generator=gen, device="cuda").bfloat16()
    t20 = torch.rand((16, 20, 16), generator=gen, device="cuda").bfloat16()
    before = (cv.conv_window_taps_launches.launches,
              conv3x3.upsample_inpad_launches.launches)
    with pytest.raises(ValueError, match="TMA"):
        cv.conv_window_taps(x3, w3, "shifted", W=9)
    with pytest.raises(ValueError, match="TMA"):
        conv3x3.upsample2x_conv3x3_inpad(x20, None, None, t20)
    assert before == (cv.conv_window_taps_launches.launches,
                      conv3x3.upsample_inpad_launches.launches)
    out = torch.empty((2, 5, 9, 40), dtype=torch.bfloat16, device="cuda")
    fn = _cuda.function("conv_arms", "dtp_conv_window_taps",
                        cv._TAPS_ARGTYPES)
    assert fn(x3.data_ptr(), w3.data_ptr(), out.data_ptr(), 2, 5, 9, 16, 3,
              40, 0, 1, 1, _cuda.stream_of(x3)) == 1
    up = torch.empty((1, 8, 8, 16), dtype=torch.bfloat16, device="cuda")
    fn = _cuda.function("conv_staged", "dtp_upsample2x_conv3x3_staged",
                        conv3x3._STAGED_ARGTYPES)
    assert fn(x20.data_ptr(), t20.data_ptr(), None, up.data_ptr(), 1, 4, 4,
              20, 16, 1, _cuda.stream_of(x20)) == 1


@pytest.mark.cuda
def test_sm90_taps_plan_matches_the_library():
    """ops/gn_conv.py taps_sm90_plan equals the built library's plan at the
    conv_arms, tool and ragged shapes, each read, forced tiles and splits
    included."""
    _setup()
    fn = _cuda.library("window_taps_sm90").dtp_conv_window_taps_sm90_plan
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 17)()
    fields = ("consumers", "pitch", "tw", "tr", "h_tiles", "x_tiles",
              "tiles_win", "m_tiles", "n_tiles", "chunks", "splits",
              "per_split", "nbox", "box_rows", "stages", "smem",
              "work_floats")
    for nwin, h_t, W, cin, n, _ in TAPS_ARMS + TAPS_TOOL + TAPS_RAGGED:
        n8 = n + (-n % 8)
        for i, read in enumerate(READS):
            for nc, splits in ((0, 0), (1, 0), (2, 3)):
                assert fn(nwin, h_t, W, _wp(W), cin, n8, i, nc, splits,
                          out) == 0
                p = gn_conv.taps_sm90_plan(nwin, h_t, W, _wp(W), cin, n8,
                                           read, nc or None, splits or None)
                assert list(out) == [p[f] for f in fields]
