// The building blocks of the port's float64 DMMA kernels (csrc/gemm.cu's
// path 3 and csrc/syrk.cu's float64 path), and the cp.async pipeline they
// share with gemm.cu's float32 path and csrc/decode_attention.cu's ring:
// the operand view, cp.async with its commit and wait, the two tile
// loaders (MN-contiguous operands staged k-major, K-contiguous ones as
// they lie), the m16n8k4 f64 fragment, the DMMA ring's constants, and the
// host checks of which copies are 16 bytes wide and of a kernel's dynamic
// shared memory.  kernels/compat.py hashes every csrc/*.cuh into every
// library's name, so an edit here rebuilds them all.
#pragma once

#include "hopper.cuh"

namespace {

// One operand as a logical [MN, K] matrix per batch: element (mn, k) of
// batch z is p[z * sb + mn * smn + k * sk].
struct Op {
    const void* p;
    long long smn, sk, sb;
};

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------
// Copy BYTES from global to shared memory, or zero-fill them when !valid
// (src-size 0: nothing is read, src only has to be a mapped address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    const int n = valid ? BYTES : 0;
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(saddr(dst)), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(saddr(dst)), "l"(src), "n"(BYTES), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage the BT x BK tile at (mn0, k0) of one operand k-major into shared
// memory, s[k * LDS + mn], zero outside the matrix.  `vec`: the operand is
// contiguous along MN with 16-byte aligned base and strides, so whole
// 16-byte runs are copied; otherwise one element per copy, neighbouring
// threads on neighbouring addresses of whichever dimension is contiguous.
template <typename T, int BT, int BK, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long smn, long long sk,
                                          int MN, int K, int mn0, int k0, int tid, bool vec) {
    constexpr int V = 16 / sizeof(T);
    if (vec) {
#pragma unroll
        for (int e = tid; e < BT * BK / V; e += THREADS) {
            const int k = e / (BT / V), mn = (e % (BT / V)) * V;
            const int gk = k0 + k, gm = mn0 + mn;
            T* dst = s + k * LDS + mn;
            if (gk < K && gm + V <= MN) {
                cp_async<16>(dst, g + static_cast<long long>(gk) * sk + gm, true);
            } else {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const bool ok = gk < K && gm + v < MN;
                    cp_async<sizeof(T)>(dst + v, ok ? g + static_cast<long long>(gk) * sk + gm + v : g, ok);
                }
            }
        }
    } else if (sk == 1) {
#pragma unroll
        for (int e = tid; e < BT * BK; e += THREADS) {
            const int k = e % BK, mn = e / BK;
            const int gk = k0 + k, gm = mn0 + mn;
            const bool ok = gk < K && gm < MN;
            cp_async<sizeof(T)>(s + k * LDS + mn, ok ? g + static_cast<long long>(gm) * smn + gk : g, ok);
        }
    } else {
#pragma unroll
        for (int e = tid; e < BT * BK; e += THREADS) {
            const int mn = e % BT, k = e / BT;
            const int gk = k0 + k, gm = mn0 + mn;
            const bool ok = gk < K && gm < MN;
            cp_async<sizeof(T)>(s + k * LDS + mn,
                                ok ? g + static_cast<long long>(gm) * smn + static_cast<long long>(gk) * sk : g, ok);
        }
    }
}

template <typename T, int BT>
__host__ __device__ constexpr int pipe_lds() { return BT + (sizeof(T) == 8 ? 8 : 4); }

// ---------------------------------------------------------------------------
// float64 on the DMMA tensor cores
// ---------------------------------------------------------------------------
// m16n8k4: the shape that reaches the full fp64 tensor rate on sm_90;
// m8n8k4 issues at half of it there
__device__ __forceinline__ void dmma(double* c, double a0, double a1, double b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a0), "d"(a1), "d"(b));
}

constexpr int DMMA_BK = 32;
constexpr int DMMA_STAGES = 3;
constexpr int DMMA_LDK = DMMA_BK + 4;    // [mn][k] rows of 288 bytes

// elements of one operand tile in either shared layout
template <int BT>
__host__ __device__ constexpr int dmma_tile() {
    return BT * DMMA_LDK > DMMA_BK * pipe_lds<double, BT>() ? BT * DMMA_LDK
                                                          : DMMA_BK * pipe_lds<double, BT>();
}
template <int BT>
__host__ __device__ constexpr int dmma_smem() { return DMMA_STAGES * 2 * dmma_tile<BT>() * 8; }

// Stage the BT x BK tile at (mn0, k0) of a K-contiguous operand as it lies,
// s[mn * LDK + k], zero outside the matrix.  `vec`: 16-byte aligned base
// and strides, so pairs of k are copied at once.
template <int BT, int BK, int LDK, int THREADS>
__device__ __forceinline__ void load_tile_km(double* s, const double* g, long long smn, long long sk,
                                             int MN, int K, int mn0, int k0, int tid, bool vec) {
    if (vec) {
#pragma unroll
        for (int e = tid; e < BT * BK / 2; e += THREADS) {
            const int mn = e / (BK / 2), k = (e % (BK / 2)) * 2;
            const int gm = mn0 + mn, gk = k0 + k;
            double* dst = s + mn * LDK + k;
            const double* src = g + static_cast<long long>(gm) * smn + gk;
            if (gm < MN && gk + 2 <= K) {
                cp_async<16>(dst, src, true);
            } else {
                const bool ok0 = gm < MN && gk < K, ok1 = gm < MN && gk + 1 < K;
                cp_async<8>(dst, ok0 ? src : g, ok0);
                cp_async<8>(dst + 1, ok1 ? src + 1 : g, ok1);
            }
        }
    } else {
#pragma unroll
        for (int e = tid; e < BT * BK; e += THREADS) {
            const int mn = e / BK, k = e % BK;
            const int gm = mn0 + mn, gk = k0 + k;
            const bool ok = gm < MN && gk < K;
            cp_async<8>(s + mn * LDK + k,
                        ok ? g + static_cast<long long>(gm) * smn + static_cast<long long>(gk) * sk : g, ok);
        }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename K>
int set_smem(K kernel, int bytes) {
    return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// 16-byte copies of an operand along MN (load_tile)
bool vec_ok(const Op& o, int elem, int batch) {
    return o.smn == 1 && aligned16(o.p) && (o.sk * elem) % 16 == 0
           && (batch == 1 || (o.sb * elem) % 16 == 0);
}

// 16-byte copies of a K-contiguous fp64 operand, pairs of k (load_tile_km)
bool vec_km(const Op& o, int batch) {
    return aligned16(o.p) && o.smn % 2 == 0 && (batch == 1 || o.sb % 2 == 0);
}

}  // namespace
