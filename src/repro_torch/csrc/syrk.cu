// Rank-k update C = op(A) op(A)^T, one triangle, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/syrk.py:_syrk_kernel
// (called by `syrk`, pallas_call at syrk.py:56).  The port's `pallas`
// venue reaches it through kernels/ops.py:kernel_syrk for every real
// syrk (blas.py:_syrk_klean); the PARSEC Gram matrix Psi^T Psi (n = 2400,
// k = 93536, float64, trans T) is its main-path shape.
//
// What bounds it on an H100: the triangle needs n(n+1)k operations
// against 8(nk + n^2) bytes; at the PARSEC shape that is 5.4e11
// operations over 1.8 GB, about 290 operations per byte, far above the
// card's 67e12 / 3.35e12 = 20: the arithmetic units bound it, not device
// memory.
//
// Design: the TPU kernel launched every (i, j) block of a 2-D grid and
// skipped the off-triangle ones with pl.when, carrying a VMEM accumulator
// along a sequential K grid axis.  Here a 1-D grid launches only the
// nt(nt+1)/2 on-triangle 64x64 tiles (block index -> (i, j) by the
// triangular-number inverse; the upper triangle takes the mirrored tile),
// so no block is spent on the other half.  Each block walks K in a loop
// with the accumulator in registers, as csrc/gemm.cu does: 256 threads,
// each owning a 4x4 register tile spread with a stride of 16 rows and 16
// columns.  Each K step stages the two 64x16 panels of op(A) (rows i and
// rows j) k-major in shared memory.  With trans = T the kernel reads a
// k x n row-major A transposed in its loads (neighbouring threads read
// neighbouring columns), so a Psi^T operand is never copied.  Tiles on
// the diagonal are masked at the store; the wrapper zero-fills the other
// triangle.  Ragged N and K edges are masked in the loads (zero fill).
//
// Types: float32, bfloat16 and float16 in with a float32 accumulator and
// the output in the input type; float64 in and out with a float64
// accumulator, matching syrk.py:54.  The simple first version: no wgmma,
// TMA or pipelining, and float64 runs on the FMA units.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int BT = 64;        // tile edge of C
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TT = BT / 16;   // rows (and columns) per thread, stride 16

// dtype codes shared with kernels/gemm.py
enum Code { F32 = 0, F64 = 1, BF16 = 2, F16 = 3 };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

// Tile t of the lower triangle, numbered row by row: (ti, tj), tj <= ti.
__device__ __forceinline__ void tile_of(long long t, int& ti, int& tj) {
    int i = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
    while (static_cast<long long>(i + 1) * (i + 2) / 2 <= t) ++i;
    while (static_cast<long long>(i) * (i + 1) / 2 > t) --i;
    ti = i;
    tj = static_cast<int>(t - static_cast<long long>(i) * (i + 1) / 2);
}

template <typename In, typename Acc, bool TRANS>
__global__ void __launch_bounds__(THREADS)
syrk_kernel(const In* __restrict__ A, In* __restrict__ C, int N, int K,
            long long lda, long long ldc, long long sa, long long sc,
            int lower) {
    // Ps[kk][r] = op(A)[row0 + r][k0 + kk], Qs the same for col0; the +1
    // keeps the transposing store of trans = N off one bank
    __shared__ Acc Ps[BK][BT + 1];
    __shared__ Acc Qs[BK][BT + 1];

    int ti, tj;
    tile_of(blockIdx.x, ti, tj);
    if (!lower) { const int t = ti; ti = tj; tj = t; }
    const int row0 = ti * BT;
    const int col0 = tj * BT;
    A += blockIdx.y * sa;
    C += blockIdx.y * sc;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    Acc acc[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = Acc(0);

    for (int k0 = 0; k0 < K; k0 += BK) {
        if (TRANS) {
            // A is K x N: op(A)[r][k] = A[k][r]; neighbouring threads read
            // neighbouring columns of one row of A
            for (int e = tid; e < BK * BT; e += THREADS) {
                const int kk = e / BT, r = e % BT;
                const long long gk = k0 + kk;
                const int gr = row0 + r, gc = col0 + r;
                const bool kin = gk < K;
                Ps[kk][r] = (kin && gr < N) ? to_acc(A[gk * lda + gr]) : Acc(0);
                Qs[kk][r] = (kin && gc < N) ? to_acc(A[gk * lda + gc]) : Acc(0);
            }
        } else {
            // A is N x K: neighbouring threads read neighbouring k
            for (int e = tid; e < BT * BK; e += THREADS) {
                const int r = e / BK, kk = e % BK;
                const int gk = k0 + kk;
                const long long gr = row0 + r, gc = col0 + r;
                const bool kin = gk < K;
                Ps[kk][r] = (kin && gr < N) ? to_acc(A[gr * lda + gk]) : Acc(0);
                Qs[kk][r] = (kin && gc < N) ? to_acc(A[gc * lda + gk]) : Acc(0);
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            Acc a[TT], b[TT];
#pragma unroll
            for (int i = 0; i < TT; ++i) a[i] = Ps[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TT; ++j) b[j] = Qs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TT; ++i)
#pragma unroll
                for (int j = 0; j < TT; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    // only the uplo triangle is written; a tile on the diagonal is masked
#pragma unroll
    for (int i = 0; i < TT; ++i) {
        const int gr = row0 + ty + 16 * i;
        if (gr >= N) continue;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const int gc = col0 + tx + 16 * j;
            const bool on_tri = lower ? (gc <= gr) : (gc >= gr);
            if (gc < N && on_tri)
                store(&C[static_cast<long long>(gr) * ldc + gc], acc[i][j]);
        }
    }
}

template <typename In, typename Acc>
int launch(const void* A, void* C, int N, int K, long long lda,
           long long ldc, int batch, long long sa, long long sc, int trans,
           int lower, cudaStream_t stream) {
    const long long nt = (N + BT - 1) / BT;
    dim3 grid(static_cast<unsigned>(nt * (nt + 1) / 2), batch);
    const In* a = static_cast<const In*>(A);
    In* c = static_cast<In*>(C);
    if (trans)
        syrk_kernel<In, Acc, true><<<grid, THREADS, 0, stream>>>(
            a, c, N, K, lda, ldc, sa, sc, lower);
    else
        syrk_kernel<In, Acc, false><<<grid, THREADS, 0, stream>>>(
            a, c, N, K, lda, ldc, sa, sc, lower);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[z] = op(A[z]) op(A[z])^T on the `lower` (1) or upper (0) triangle for
// z < batch.  op(A) is N x K: A itself (trans = 0, A is N x K) or A^T
// (trans = 1, A is K x N).  A and C have unit column strides; lda/ldc are
// row strides and sa/sc batch strides, in elements.  C's other triangle
// is not written.  Returns cudaGetLastError() after the launch, or -1 for
// a dtype the kernel does not take and -2 for a grid the card cannot
// launch.
extern "C" int repro_syrk(int code, const void* A, void* C, int N, int K,
                          long long lda, long long ldc, int batch,
                          long long sa, long long sc, int trans, int lower,
                          void* stream) {
    if (N <= 0 || K < 0 || batch <= 0 || batch > 65535) return -2;
    const long long nt = (N + BT - 1) / BT;
    if (nt * (nt + 1) / 2 > 2147483647LL) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == F32)
        return launch<float, float>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    if (code == F64)
        return launch<double, double>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    if (code == BF16)
        return launch<__nv_bfloat16, float>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    if (code == F16)
        return launch<__half, float>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    return -1;
}
