'''The CUDA sources of kernels K9/K12 (newtonnet_tpu_torch/csrc/row_gather.cu)
and K10/K11 (csrc/window.cu) run on the CPU under the emulation of CUDA's
thread model (tests/torch_kernel_emu.py), against the plain PyTorch
versions.
'''
import ctypes

import numpy as np
import pytest
import torch

from newtonnet_tpu_torch.ops import row_gather as rg
from newtonnet_tpu_torch.ops import window as wn
from torch_kernel_emu import compile_emu, source


@pytest.fixture(scope='module')
def gather_lib(tmp_path_factory):
    handle = compile_emu(tmp_path_factory.mktemp('emu_gather'),
                         'row_gather_emu', source('row_gather'))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_row_gather.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong,
                                     i, p]
    handle.nn_row_gather.restype = i
    return handle


@pytest.mark.parametrize('B, N, F, R, dtype, idx_dtype', [
    (2, 7, 3, 11, torch.float32, torch.int32),       # 12-byte rows: words
    (1, 10, 16, 37, torch.bfloat16, torch.int64),    # 16-byte vectors
    (2, 5, 5, 9, torch.bfloat16, torch.int32),       # 10 bytes: half-words
    (3, 6, 64, 20, torch.float32, torch.int64)])
def test_emulated_row_gather_matches_plain(gather_lib, B, N, F, R, dtype,
                                           idx_dtype):
    """K9 copies rows bit for bit at every word size the source picks, from
    a source whose batch stride is not N rows (a slot chunk of a larger
    tensor, as inv_scatter_sum passes it)."""
    rs = np.random.RandomState(B * 100 + F)
    big = torch.tensor(rs.randn(B, N + 3, F), dtype=torch.float32).to(dtype)
    x = big[:, 2:2 + N]
    idx = torch.tensor(rs.randint(0, N, size=(B, R)), dtype=idx_dtype)
    out = torch.full((B, R, F), float('nan'), dtype=dtype)
    assert gather_lib.nn_row_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, R,
        F * x.element_size(), x.stride(0) // F,
        int(idx_dtype == torch.int64), None) == 0
    assert torch.equal(out, rg.row_gather_ref(x, idx))


def test_emulated_row_gather_zeroes_rows_out_of_range(gather_lib):
    """An index outside [0, N) gives a zero row and no read outside x; an
    empty problem is refused."""
    x = torch.randn(1, 4, 8)
    idx = torch.tensor([[0, 4, -1, 3]], dtype=torch.int32)
    out = torch.full((1, 4, 8), float('nan'))
    assert gather_lib.nn_row_gather(x.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), 1, 4, 4, 32, 4, 0,
                                    None) == 0
    assert torch.equal(out[0, 0], x[0, 0]) and torch.equal(out[0, 3], x[0, 3])
    assert not out[0, 1:3].any()
    assert gather_lib.nn_row_gather(x.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), 1, 4, 0, 32, 4, 0,
                                    None) == 1


@pytest.fixture(scope='module')
def window_lib(tmp_path_factory):
    handle = compile_emu(tmp_path_factory.mktemp('emu_window'), 'window_emu',
                         source('window'))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_window_gather.argtypes = [p, p, p] + [i] * 8 + [p]
    handle.nn_window_gather.restype = i
    handle.nn_window_scatter.argtypes = [p] * 4 + [i] * 8 + [p]
    handle.nn_window_scatter.restype = i
    handle.nn_window_scratch_bytes.argtypes = [i] * 6
    handle.nn_window_scratch_bytes.restype = ctypes.c_size_t
    return handle


@pytest.mark.parametrize('B, K, N, F, W, T, dtype', [
    (2, 3, 256, 16, 128, 128, torch.bfloat16),
    (1, 5, 96, 6, 40, 32, torch.float32),
    (1, 9, 512, 8, 256, 128, torch.bfloat16)])
def test_emulated_window_kernels_match_plain(window_lib, B, K, N, F, W, T,
                                             dtype):
    """K10 equals its plain version bit for bit (the window test and the
    bf16 rounding); K11 equals the plain index_add_ within 1e-6 of the
    largest magnitude plus one ulp of the output dtype (fp32 sums in
    another order), with edges in and out of their windows and indices of
    both widths; with int64 indices a third of the edges point at atom 0,
    a window row with a long run of edges (as masked slots pointed at a
    block's start make). The last case sorts its 4608 edges in three tiles
    of K11's radix sort."""
    rs = np.random.RandomState(N + K)
    x = torch.tensor(rs.randn(B, N, F), dtype=torch.float32).to(dtype)
    y = torch.tensor(rs.randn(B, K, N, F), dtype=torch.float32).to(dtype)
    for idx_dtype in (torch.int32, torch.int64):
        idx = torch.tensor(rs.randint(0, N, size=(B, K, N)), dtype=idx_dtype)
        if idx_dtype == torch.int64:
            idx[..., ::3] = 0
        loc = wn.window_locals(idx, W, T)
        assert (loc < W).any() and (loc >= W).any()
        i64 = int(idx_dtype == torch.int64)
        bf = int(dtype == torch.bfloat16)
        out = torch.full((B, K, N, F), float('nan'), dtype=dtype)
        assert window_lib.nn_window_gather(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, K, N, F, W, T,
            bf, i64, None) == 0
        assert torch.equal(out, wn.window_gather_ref(x, idx, W, T))
        scratch = torch.full(
            (window_lib.nn_window_scratch_bytes(B, K, N, F, W, T),), 255,
            dtype=torch.uint8)
        got = torch.full((B, N, F), float('nan'), dtype=dtype)
        assert window_lib.nn_window_scatter(
            y.data_ptr(), idx.data_ptr(), scratch.data_ptr(), got.data_ptr(), B,
            K, N, F, W, T, bf, i64, None) == 0
        want = wn.window_scatter_sum_ref(y, idx, W, T).float()
        ulp = torch.finfo(dtype).eps * want.abs()
        assert ((got.float() - want).abs()
                <= 1e-6 * want.abs().max() + ulp).all()


def _scatter(lib, y, idx, W, T):
    B, K, N = idx.shape
    F = y[0, 0, 0].numel()
    scratch = torch.full((lib.nn_window_scratch_bytes(B, K, N, F, W, T),),
                         255, dtype=torch.uint8)
    got = torch.full((B, N, F), float('nan'), dtype=y.dtype)
    assert lib.nn_window_scatter(
        y.data_ptr(), idx.data_ptr(), scratch.data_ptr(), got.data_ptr(), B,
        K, N, F, W, T, int(y.dtype == torch.bfloat16),
        int(idx.dtype == torch.int64), None) == 0
    return got


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_emulated_window_scatter_sums_long_runs_and_repeats_its_bits(
        window_lib, dtype):
    """K11 on a cell-sorted-like list whose masked slots (two in five) point
    at their block's window start, as chip_smoke.window_list makes them:
    four rows with runs of about 460 edges, over two or three of the
    kernel's 256-position segments, beside rows of a few edges, rows with
    none and edges out of their windows. int32 and int64 indices, fp32 and
    bf16 payloads; within 1e-6 of the largest magnitude plus one ulp of the
    output dtype of the plain index_add_, and a second launch gives the
    same bits."""
    B, K, N, F, W, T = 1, 9, 512, 8, 256, 128
    rs = np.random.RandomState(7)
    y = torch.tensor(rs.randn(B, K, N, F), dtype=torch.float32).to(dtype)
    starts = torch.tensor(wn.window_starts(N, W, T)).repeat_interleave(T)
    near = starts[None, None] + torch.tensor(rs.randint(0, W + 8,
                                                        size=(B, K, N)))
    masked = torch.tensor(rs.rand(B, K, N) < 0.4)
    for idx_dtype in (torch.int32, torch.int64):
        idx = torch.where(masked, starts[None, None], near % N).to(idx_dtype)
        loc = wn.window_locals(idx, W, T)
        assert (loc >= W).any()
        got = _scatter(window_lib, y, idx, W, T)
        want = wn.window_scatter_sum_ref(y, idx, W, T).float()
        ulp = torch.finfo(dtype).eps * want.abs()
        assert ((got.float() - want).abs()
                <= 1e-6 * want.abs().max() + ulp).all()
        assert torch.equal(got, _scatter(window_lib, y, idx, W, T))


def test_emulated_window_kernels_refuse_what_they_do_not_take(window_lib):
    """N not a multiple of T, W above N, or more edges than K11's 32-bit
    edge ids hold: cudaErrorInvalidValue (and no scratch size). K11's sort
    holds no block's edges in shared memory, so K * T is not bounded."""
    x, idx, out = torch.zeros(1, 8, 4), torch.zeros(1, 2, 8,
                                                   dtype=torch.int32), \
        torch.zeros(1, 2, 8, 4)
    args = (x.data_ptr(), idx.data_ptr(), out.data_ptr())
    assert window_lib.nn_window_gather(*args, 1, 2, 8, 4, 4, 3, 0, 0,
                                       None) == 1
    assert window_lib.nn_window_gather(*args, 1, 2, 8, 4, 9, 4, 0, 0,
                                       None) == 1
    assert window_lib.nn_window_scratch_bytes(1, 300, 256, 4, 128, 128) > 0
    assert window_lib.nn_window_scratch_bytes(1, 1 << 16, 1 << 15, 4, 128,
                                              128) == 0
    assert window_lib.nn_window_scatter(x.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), out.data_ptr(), 1,
                                        1 << 16, 1 << 15, 4, 128, 128, 0, 0,
                                        None) == 1
    assert window_lib.nn_window_scatter(x.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), out.data_ptr(), 1, 2,
                                        8, 4, 4, 3, 0, 0, None) == 1
