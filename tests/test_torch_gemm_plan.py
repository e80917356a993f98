"""The gemm kernel's path plan (``gemm.plan``) at the main paths' shapes.

Meta tensors carry the shapes and strides, so nothing is allocated:
PARSEC's projection ``h.mT @ Psi`` (32 x 2400 x 93536 float64) takes
path 5, float64 with fewer than 64 rows, with K split so that its grid
fills the card; LSMS's float64 planes keep path 3's 128-edge DMMA tiles;
float32 and 16-bit plans are as before the float64 skinny path existed.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gemm  # noqa: E402

F64, F32, BF16, F16 = torch.float64, torch.float32, torch.bfloat16, \
    torch.float16
SMS = 132


def _meta(rows, cols, dtype, trans=False, batch=0):
    """A rows x cols meta matrix (a batch of them), stored transposed
    when ``trans``."""
    lead = (batch,) if batch else ()
    if trans:
        return torch.empty(*lead, cols, rows, dtype=dtype, device="meta").mT
    return torch.empty(*lead, rows, cols, dtype=dtype, device="meta")


#: id: (M, K, N, dtype, A transposed, B transposed, batch, kernel_block,
#: the plan)
CASES = {
    "parsec_h_mT_psi": (32, 93536, 2400, F64, True, False, 0, 0,
                        (gemm.SKINNY_F64, 0, 28)),
    "m1": (1, 20011, 2400, F64, False, False, 0, 0, (gemm.SKINNY_F64, 0, 28)),
    "m17": (17, 20011, 2400, F64, True, False, 0, 0,
            (gemm.SKINNY_F64, 0, 28)),
    "m63_b_transposed": (63, 20011, 2400, F64, False, True, 0, 0,
                         (gemm.SKINNY_F64, 0, 28)),
    "m32_batch3": (32, 20011, 2400, F64, True, False, 3, 0,
                   (gemm.SKINNY_F64, 0, 10)),
    "m32_short_k": (32, 200, 93, F64, False, False, 0, 0,
                    (gemm.SKINNY_F64, 0, 1)),
    "parsec_block64": (32, 93536, 2400, F64, True, False, 0, 64,
                       (gemm.SKINNY_F64, 0, 28)),
    "parsec_block128": (32, 93536, 2400, F64, True, False, 0, 128,
                        (gemm.SKINNY_F64, 0, 28)),
    "m64": (64, 20011, 2400, F64, True, False, 0, 0, (gemm.DMMA, 128, 1)),
    "lsms_plane_6912": (6912, 6912, 6912, F64, False, False, 0, 0,
                        (gemm.DMMA, 128, 1)),
    "getrf_update_6656x6656x256": (6656, 256, 6656, F64, False, False, 0, 0,
                                   (gemm.DMMA, 128, 1)),
    "getrf_update_256": (256, 256, 256, F64, False, False, 0, 0,
                         (gemm.DMMA, 128, 1)),
    "m64_block64": (64, 20011, 2400, F64, True, False, 0, 64,
                    (gemm.DMMA, 64, 1)),
    "f32_parsec_shape": (32, 93536, 2400, F32, True, False, 0, 0,
                         (gemm.SIMT, 128, 1)),
    "f32_block64": (32, 93536, 2400, F32, True, False, 0, 64,
                    (gemm.SIMT, 64, 1)),
    "bf16_decode_kv": (2, 3584, 2048, BF16, False, False, 0, 0,
                       (gemm.SKINNY, 0, 28)),
    "bf16_decode_mlp": (2, 3584, 14336, BF16, False, False, 0, 0,
                        (gemm.SKINNY, 0, 5)),
    "bf16_vocab_head": (2, 3584, 256000, BF16, False, True, 0, 0,
                        (gemm.SKINNY, 0, 1)),
    "bf16_prefill": (9216, 3584, 14336, BF16, False, False, 0, 0,
                     (gemm.TC, 256, 1)),
    "f16_decode_kv": (2, 3584, 2048, F16, False, False, 0, 0,
                      (gemm.SKINNY, 0, 28)),
    "f16_prefill_block128": (9216, 3584, 14336, F16, False, False, 0, 128,
                             (gemm.TC, 128, 1)),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_plan_at_main_path_shapes(case):
    m, k, n, dtype, ta, tb, batch, block, want = case
    a = _meta(m, k, dtype, ta, batch)
    b = _meta(k, n, dtype, tb, batch)
    p = gemm.plan(a, b, block)
    assert p == want
    if p.path == gemm.SKINNY_F64 and p.splits > 1:
        # the K ranges' blocks fill every SM, each range keeping its share
        blocks = -(-n // gemm.SKINNY_F64_COLS) * max(batch, 1) * p.splits
        assert blocks >= SMS
        assert k // p.splits >= gemm.SKINNY_MIN_K
