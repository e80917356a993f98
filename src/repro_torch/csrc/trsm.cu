// Triangular-solve base case L X = B for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/trsm.py:_trsm_base_kernel
// (called by `_trsm_base`, pallas_call at trsm.py:66): row substitution
// on one lower-triangular diagonal block of at most 128 rows.  The
// recursion that reduces a large solve to these blocks plus gemm updates,
// and the reduction of all side/uplo/trans variants to lower-left-N, stay
// in Python (kernels/trsm.py), with the updates on the port's gemm kernel.
//
// What bounds it on an H100: the main path's solve (float64, m = 6912
// rows, 32 right-hand sides) reads the m*m/2 triangle once and does m*m*n
// operations, n/4 = 8 operations per byte of triangle; the card does 20,
// so at full speed the whole solve would be memory-bound.  This base case is
// bound by neither: it is a chain of 128 dependent steps, each a short
// parallel update followed by a barrier, so latency bounds it.
//
// Design: one block of 256 threads per 32-column panel of B (a batched
// call adds a grid dimension).  The block copies the triangle into shared
// memory transposed (column i of L is contiguous, so the threads of a warp
// read one broadcast word) and the panel beside it: 128 KB + 32 KB for
// float64, above the 48 KB default, so the launch raises the block's
// dynamic shared-memory limit first.  Row i is then finished (divided by
// the diagonal unless the diagonal is unit), and every thread subtracts
// L[r][i] * X[i][j] from its share of the rows below: one barrier after
// each of the two steps.  The TPU kernel instead formed each row's dot
// product with the rows above it as a masked vector-matrix product; the
// column-oriented order here keeps all 256 threads busy on every step.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_NB = 128;
constexpr int PANEL = 32;
constexpr int THREADS = 256;

// dtype codes shared with kernels/gemm.py and kernels/trsm.py
enum Code { F32 = 0, F64 = 1 };

template <typename T>
__global__ void __launch_bounds__(THREADS)
trsm_base_kernel(const T* __restrict__ L, const T* __restrict__ B,
                 T* __restrict__ X, int nb, int n, long long ldl,
                 long long ldb, long long ldx, long long sl, long long sb,
                 long long sx, int unit) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Lt = reinterpret_cast<T*>(smem_raw);   // Lt[c * nb + r] = L[r][c]
    T* Xs = Lt + nb * nb;                      // nb x PANEL panel

    const int tid = threadIdx.x;
    const int col0 = blockIdx.x * PANEL;
    L += blockIdx.y * sl;
    B += blockIdx.y * sb;
    X += blockIdx.y * sx;

    for (int e = tid; e < nb * nb; e += THREADS) {
        const int r = e / nb, c = e % nb;
        Lt[c * nb + r] = (c <= r) ? L[r * ldl + c] : T(0);
    }
    for (int e = tid; e < nb * PANEL; e += THREADS) {
        const int r = e / PANEL, gc = col0 + e % PANEL;
        Xs[e] = (gc < n) ? B[r * ldb + gc] : T(0);
    }
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
        if (!unit) {
            if (tid < PANEL) Xs[i * PANEL + tid] = Xs[i * PANEL + tid] / Lt[i * nb + i];
            __syncthreads();
        }
        const T* li = Lt + i * nb;   // column i of L
        const T* xi = Xs + i * PANEL;
        for (int e = (i + 1) * PANEL + tid; e < nb * PANEL; e += THREADS) {
            Xs[e] -= li[e / PANEL] * xi[e % PANEL];
        }
        __syncthreads();
    }

    for (int e = tid; e < nb * PANEL; e += THREADS) {
        const int r = e / PANEL, gc = col0 + e % PANEL;
        if (gc < n) X[r * ldx + gc] = Xs[e];
    }
}

template <typename T>
int launch(const void* L, const void* B, void* X, int nb, int n,
           long long ldl, long long ldb, long long ldx, int batch,
           long long sl, long long sb, long long sx, int unit,
           cudaStream_t stream) {
    const size_t smem = sizeof(T) * (static_cast<size_t>(nb) * nb
                                     + static_cast<size_t>(nb) * PANEL);
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&trsm_base_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((n + PANEL - 1) / PANEL, batch);
    trsm_base_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(L), static_cast<const T*>(B),
        static_cast<T*>(X), nb, n, ldl, ldb, ldx, sl, sb, sx, unit);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X[z] = L[z]^-1 B[z] for z < batch: L is nb x nb lower triangular (the
// strict upper part is never read; with unit != 0 neither is the
// diagonal), B and X are nb x n; unit column strides, row strides
// ldl/ldb/ldx and batch strides sl/sb/sx in elements.  Returns
// cudaGetLastError() after the launch, -1 for a dtype the kernel does not
// take and -2 for a shape it cannot launch.
extern "C" int repro_trsm_base(int code, const void* L, const void* B,
                               void* X, int nb, int n, long long ldl,
                               long long ldb, long long ldx, int batch,
                               long long sl, long long sb, long long sx,
                               int unit, void* stream) {
    if (nb <= 0 || nb > MAX_NB || n <= 0 || batch <= 0 || batch > 65535)
        return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == F32)
        return launch<float>(L, B, X, nb, n, ldl, ldb, ldx, batch, sl, sb, sx, unit, s);
    if (code == F64)
        return launch<double>(L, B, X, nb, n, ldl, ldb, ldx, batch, sl, sb, sx, unit, s);
    return -1;
}
