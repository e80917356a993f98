// Split-precision fp64 product C = A @ B for Hopper (sm_90a), plain C
// interface: the slice cross passes of core/precision.py in one kernel.
//
// Replaces the pass stream of src/repro/kernels/split_gemm.py:31-63
// (`pass_mm` / `matmul` / `syrk` / `trsm`, each pass a pallas_call of
// gemm.py:67).  The port's `pallas` venue reaches it through
// kernels/split_gemm.py for every split product: the venue's split gemm
// (core/blas.py `_split_matmul`), split syrk (A^T A) and the refinement
// product of split trsm.  PARSEC's projection S = Hpsi_blk^T Psi (M 32, N
// 2400, K 93536) is its main-path shape.
//
// What it computes, exactly as precision.matmul does with a float32 pass
// primitive: each fp64 operand is cut into slices (precision.slices) --
// hi = fp32(x), rem = x - hi (exact), lo = fp32(rem), and for split3 the
// tail fp32(bf16(rem - lo)), the bf16 rounding taken through float as
// PyTorch's float64 -> bfloat16 conversion takes it (c10's BFloat16 is
// built from a float: two round-to-nearest-even steps) -- and every cross
// pass of the scheme (precision._PASSES) is an fp32 product with IEEE fmaf
// accumulation (no TF32 or tensor cores: the bounds (k+12) eps32 and
// (256+24) eps32 assume true fp32 products).  split3 widens each pass to
// fp64 after every 256 columns of K (SPLIT3_CHUNK) and adds it into one
// fp64 accumulator.  split2 is not chunked in the reference; here its fp32
// runs end at the block's K-range boundary, which can only shorten them
// and so stays within its bound.
//
// What bounds it on an H100: the function is an fp64 product, 2MNK
// operations on 8(MK + KN + MN) bytes; at PARSEC's shape it reads Psi (1.8
// GB) once and is bound by bytes (0.54 ms).  The six fp32 passes cost 6 x
// 2MNK = 8.6e10 operations, 1.29 ms at the 67 TFLOP/s fp32 FMA peak: on
// this card the fp64 DMMA rate equals the fp32 FMA rate, so six fp32
// passes cannot beat one fp64 product, and the passes' floor is 1.29 ms.
//
// Design: one launch runs every pass, instead of one product per pass per
// 256-column chunk (2196 at PARSEC's shape, each on 38 blocks), and no
// slice is written to device memory: fp64 A and B are read once, in
// either layout (a transposed view is read transposed in the loads, no
// copy), and sliced on the way into shared memory; the passes of a 32 x 128 output tile run in
// registers (4 x 4 outputs per thread, one fp32 accumulator per pass, and
// two fp64 accumulators each: the hi x hi pass and the rest, kept apart
// so that a hi x hi sum that cancels over K leaves the small passes
// intact, as precision.matmul's pass-by-pass sums do).  With M = 32 and N = 2400 there are only 19
// output tiles, so K is split across blocks at chunk boundaries (a
// `splits` axis of the grid) and every block writes its two fp64 partial
// tiles to scratch; a second launch sums the partials in split order: no
// atomics, the same bits run to run.  The next 16 columns of K are loaded
// into registers while the current ones are multiplied.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int CHUNK = 256;      // precision.SPLIT3_CHUNK
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;     // padded rows: a k-contiguous operand's
constexpr int LDB = BN + 4;     // transposing stores spread over 8 banks

// precision.slices, element by element
__device__ __forceinline__ void slice(double x, float& hi, float& lo, float& tail) {
    hi = __double2float_rn(x);
    const double rem = x - static_cast<double>(hi);
    lo = __double2float_rn(rem);
    const double rem2 = rem - static_cast<double>(lo);
    tail = __bfloat162float(__float2bfloat16_rn(__double2float_rn(rem2)));
}

// the cross passes of precision._PASSES, as (slice of A, slice of B)
__device__ __forceinline__ constexpr int pass_a(int q) { return q == 4 ? 0 : q == 5 ? 2 : q / 2; }
__device__ __forceinline__ constexpr int pass_b(int q) { return q == 4 ? 2 : q == 5 ? 0 : q % 2; }

template <int NS>
__global__ void __launch_bounds__(THREADS, 1)
split_pass_kernel(const double* __restrict__ A, const double* __restrict__ B,
                  double* __restrict__ W, int M, int N, int K, long long a_sm,
                  long long a_sk, long long b_sk, long long b_sn, int splits,
                  int pass_mask) {
    constexpr int NP = NS == 3 ? 6 : 3;
    constexpr int AE = BM * BK / THREADS;
    constexpr int BE = BK * BN / THREADS;
    __shared__ __align__(16) float sA[NS][BK][LDA];
    __shared__ __align__(16) float sB[NS][BK][LDB];
    const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
    const int chunks = (K + CHUNK - 1) / CHUNK;
    const int cb = static_cast<int>(static_cast<long long>(split) * chunks / splits);
    const int ce = static_cast<int>(static_cast<long long>(split + 1) * chunks / splits);
    const int ke = min(K, ce * CHUNK);

    // fp64 sums of the hi x hi pass and of all the others, apart: the
    // first can be large and cancel over K while the others are 2^-24 of
    // it and smaller, so one running sum would round them away
    double acc[2][4][4];
    float p[NP][4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            acc[0][r][c] = acc[1][r][c] = 0.0;
#pragma unroll
            for (int q = 0; q < NP; ++q) p[q][r][c] = 0.f;
        }

    // element e of a step's A (BM x BK) and B (BK x BN) tiles: neighbouring
    // threads on the operand's contiguous dimension
    auto a_at = [&](int e, int& m, int& k) {
        if (a_sk == 1) { m = e / BK; k = e % BK; } else { m = e % BM; k = e / BM; }
    };
    auto b_at = [&](int e, int& k, int& n) {
        if (b_sk == 1) { n = e / BK; k = e % BK; } else { n = e % BN; k = e / BN; }
    };
    double ra[AE], rb[BE];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < AE; ++i) {
            int m, k;
            a_at(tid + i * THREADS, m, k);
            const int gm = m0 + m, gk = k0 + k;
            ra[i] = (gm < M && gk < ke) ? A[gm * a_sm + gk * a_sk] : 0.0;
        }
#pragma unroll
        for (int i = 0; i < BE; ++i) {
            int k, n;
            b_at(tid + i * THREADS, k, n);
            const int gn = n0 + n, gk = k0 + k;
            rb[i] = (gn < N && gk < ke) ? B[gk * b_sk + gn * b_sn] : 0.0;
        }
    };
    auto put = [&]() {
#pragma unroll
        for (int i = 0; i < AE; ++i) {
            int m, k;
            a_at(tid + i * THREADS, m, k);
            float s[3];
            slice(ra[i], s[0], s[1], s[2]);
#pragma unroll
            for (int j = 0; j < NS; ++j) sA[j][k][m] = s[j];
        }
#pragma unroll
        for (int i = 0; i < BE; ++i) {
            int k, n;
            b_at(tid + i * THREADS, k, n);
            float s[3];
            slice(rb[i], s[0], s[1], s[2]);
#pragma unroll
            for (int j = 0; j < NS; ++j) sB[j][k][n] = s[j];
        }
    };
    auto widen = [&]() {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int q = 0; q < NP; ++q) {
                    if (pass_mask >> q & 1) acc[q > 0][r][c] += static_cast<double>(p[q][r][c]);
                    p[q][r][c] = 0.f;
                }
    };

    if (cb < ce) fetch(cb * CHUNK);
    for (int ch = cb; ch < ce; ++ch) {
        for (int st = 0; st < CHUNK / BK; ++st) {
            const int k0 = ch * CHUNK + st * BK;
            if (k0 >= ke) break;
            __syncthreads();
            put();
            __syncthreads();
            if (k0 + BK < ke) fetch(k0 + BK);
#pragma unroll 4
            for (int kk = 0; kk < BK; ++kk) {
                float a[NS][4], b[NS][4];
#pragma unroll
                for (int j = 0; j < NS; ++j) {
                    const float4 x = *reinterpret_cast<const float4*>(&sA[j][kk][ty * 4]);
                    const float4 y = *reinterpret_cast<const float4*>(&sB[j][kk][tx * 4]);
                    a[j][0] = x.x; a[j][1] = x.y; a[j][2] = x.z; a[j][3] = x.w;
                    b[j][0] = y.x; b[j][1] = y.y; b[j][2] = y.z; b[j][3] = y.w;
                }
#pragma unroll
                for (int q = 0; q < NP; ++q)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            p[q][r][c] = fmaf(a[pass_a(q)][r], b[pass_b(q)][c], p[q][r][c]);
            }
        }
        if (NS == 3) widen();   // split3: fp64 after every chunk
    }
    if (NS == 2) widen();       // split2: one fp32 run over the block's range

    const long long mn = static_cast<long long>(M) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        double* w = W + (static_cast<long long>(h) * splits + split) * mn;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int gm = m0 + ty * 4 + r;
            if (gm >= M) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int gn = n0 + tx * 4 + c;
                if (gn < N) w[static_cast<long long>(gm) * N + gn] = acc[h][r][c];
            }
        }
    }
}

// C = the hi x hi partials summed in split order, plus the others summed
// the same way: W holds the first in its first `splits` planes
__global__ void __launch_bounds__(256)
split_reduce_kernel(const double* __restrict__ W, double* __restrict__ C, long long mn,
                    int splits) {
    const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    if (i >= mn) return;
    double hi = 0.0, rest = 0.0;
    for (int q = 0; q < splits; ++q) hi += W[q * mn + i];
    for (int q = 0; q < splits; ++q) rest += W[(splits + q) * mn + i];
    C[i] = hi + rest;
}

__global__ void __launch_bounds__(256)
slices_kernel(const double* __restrict__ x, float* hi, float* lo, float* tail, long long n) {
    const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    if (i >= n) return;
    float h, l, t;
    slice(x[i], h, l, t);
    hi[i] = h;
    lo[i] = l;
    if (tail != nullptr) tail[i] = t;
}

}  // namespace

// C (M x N, contiguous) = A @ B in fp64 by the split scheme's passes
// (scheme 2: split2, 3: split3).  Element (m, k) of A is A[m * a_sm + k *
// a_sk], (k, n) of B is B[k * b_sk + n * b_sn]; W is fp64 scratch of
// 2 * splits * M * N.  Bit q of pass_mask keeps pass q of precision._PASSES
// in the sum (all bits set but for the negative controls that leave one
// out).  Two launches: the passes, then the reduction.  Returns
// cudaGetLastError(), or -2 for arguments it cannot launch.
extern "C" int repro_split_gemm(int scheme, const double* A, const double* B, double* C,
                                double* W, int M, int N, int K, long long a_sm, long long a_sk,
                                long long b_sk, long long b_sn, int splits, int pass_mask,
                                void* stream) {
    if (M <= 0 || N <= 0 || K < 0 || splits < 1 || splits > 65535) return -2;
    if ((scheme != 2 && scheme != 3) || (M + BM - 1) / BM > 65535) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    if (scheme == 3)
        split_pass_kernel<3><<<grid, THREADS, 0, s>>>(A, B, W, M, N, K, a_sm, a_sk, b_sk, b_sn, splits, pass_mask);
    else
        split_pass_kernel<2><<<grid, THREADS, 0, s>>>(A, B, W, M, N, K, a_sm, a_sk, b_sk, b_sn, splits, pass_mask);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const long long mn = static_cast<long long>(M) * N;
    split_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(W, C, mn, splits);
    return static_cast<int>(cudaGetLastError());
}

// The slices precision.slices makes of n contiguous fp64 values: hi, lo
// and (tail non-null) the split3 tail, each as fp32.
extern "C" int repro_split_slices(const double* x, float* hi, float* lo, float* tail,
                                  long long n, void* stream) {
    if (n <= 0) return n == 0 ? 0 : -2;
    slices_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        x, hi, lo, tail, n);
    return static_cast<int>(cudaGetLastError());
}
