// Tiled matrix product C = A @ B for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gemm.py:_gemm_kernel
// (called by `gemm`, pallas_call at gemm.py:67).  Every offloaded level-3
// BLAS routine of the port reaches it through kernels/ops.py:matmul, the
// complex ones as four real products (4M), and the update step of the
// trsm recursion calls it directly.
//
// What bounds it on an H100: at the sizes the main path gives it (the LSMS
// KKR product, 6912^3 in float64 per real plane) the work is 2*M*N*K
// operations against 8*(MK + KN + MN) bytes, about 576 operations per
// byte, far above the card's 67e12 / 3.35e12 = 20 operations per byte: the
// arithmetic units bound it, not device memory.
//
// Design: one 64x64 output tile per block of 256 threads, each thread
// owning a 4x4 register tile spread with a stride of 16 rows and 16
// columns, so a warp reads neighbouring shared-memory words and writes
// neighbouring output words.  The TPU kernel walked K as the sequential
// third grid axis with a VMEM accumulator carried between grid steps;
// blocks on Hopper run in no order, so here the K walk is a loop inside
// the block and the accumulator lives in registers.  Each K step stages a
// 64x16 slice of A (stored k-major) and a 16x64 slice of B in shared
// memory, converted to the accumulation type on the way in.  Ragged M, N
// and K edges are masked in the loads (zero fill) and the store, instead
// of padding the operands and cropping the result.
//
// Types: float32 in and out, computed in IEEE float32 FMAs (no TF32);
// bfloat16 or float16 in with a float32 accumulator and the output in the
// input type or float32; float64 in and out with a float64 accumulator,
// matching gemm.py:59.  This is the simple first version: no wgmma, TMA or
// pipelining yet, and float64 runs on the FMA units rather than the DMMA
// tensor cores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = BM / 16;   // rows per thread (stride 16)
constexpr int TN = BN / 16;   // columns per thread (stride 16)

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

template <typename In, typename Acc, typename Out>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const In* __restrict__ A, const In* __restrict__ B,
            Out* __restrict__ C, int M, int N, int K,
            long long lda, long long ldb, long long ldc,
            long long sa, long long sb, long long sc) {
    // A slice, k-major; the +1 keeps the transposing store off one bank
    __shared__ Acc As[BK][BM + 1];
    __shared__ Acc Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    A += blockIdx.z * sa;
    B += blockIdx.z * sb;
    C += blockIdx.z * sc;

    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

    for (int k0 = 0; k0 < K; k0 += BK) {
        // A slice: 64 rows x 16 k; neighbouring threads read neighbouring k
        for (int e = tid; e < BM * BK; e += THREADS) {
            const int r = e / BK, c = e % BK;
            const int gr = row0 + r, gc = k0 + c;
            As[c][r] = (gr < M && gc < K) ? to_acc(A[gr * lda + gc]) : Acc(0);
        }
        // B slice: 16 k x 64 columns; neighbouring threads read neighbouring columns
        for (int e = tid; e < BK * BN; e += THREADS) {
            const int r = e / BN, c = e % BN;
            const int gr = k0 + r, gc = col0 + c;
            Bs[r][c] = (gr < K && gc < N) ? to_acc(B[gr * ldb + gc]) : Acc(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            Acc a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gr = row0 + ty + 16 * i;
        if (gr >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gc = col0 + tx + 16 * j;
            if (gc < N) store(&C[gr * ldc + gc], acc[i][j]);
        }
    }
}

template <typename In, typename Acc, typename Out>
int launch(const void* A, const void* B, void* C, int M, int N, int K,
           long long lda, long long ldb, long long ldc, int batch,
           long long sa, long long sb, long long sc, cudaStream_t stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
    gemm_kernel<In, Acc, Out><<<grid, THREADS, 0, stream>>>(
        static_cast<const In*>(A), static_cast<const In*>(B),
        static_cast<Out*>(C), M, N, K, lda, ldb, ldc, sa, sb, sc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[z] = A[z] @ B[z] for z < batch.  A is M x K, B is K x N, C is M x N,
// all with unit column stride; lda/ldb/ldc are row strides and sa/sb/sc
// batch strides, in elements.  Returns cudaGetLastError() after the
// launch, or -1 for a type pair the kernel does not take and -2 for a
// grid the card cannot launch.
extern "C" int repro_gemm(int in_code, int out_code, const void* A,
                          const void* B, void* C, int M, int N, int K,
                          long long lda, long long ldb, long long ldc,
                          int batch, long long sa, long long sb,
                          long long sc, void* stream) {
    if (M <= 0 || N <= 0 || batch <= 0) return -2;
    if ((M + BM - 1) / BM > 65535 || batch > 65535) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_code == F32 && out_code == F32)
        return launch<float, float, float>(A, B, C, M, N, K, lda, ldb, ldc, batch, sa, sb, sc, s);
    if (in_code == F64 && out_code == F64)
        return launch<double, double, double>(A, B, C, M, N, K, lda, ldb, ldc, batch, sa, sb, sc, s);
    if (in_code == BF16 && out_code == BF16)
        return launch<__nv_bfloat16, float, __nv_bfloat16>(A, B, C, M, N, K, lda, ldb, ldc, batch, sa, sb, sc, s);
    if (in_code == BF16 && out_code == F32)
        return launch<__nv_bfloat16, float, float>(A, B, C, M, N, K, lda, ldb, ldc, batch, sa, sb, sc, s);
    if (in_code == F16 && out_code == F16)
        return launch<__half, float, __half>(A, B, C, M, N, K, lda, ldb, ldc, batch, sa, sb, sc, s);
    if (in_code == F16 && out_code == F32)
        return launch<__half, float, float>(A, B, C, M, N, K, lda, ldb, ldc, batch, sa, sb, sc, s);
    return -1;
}
