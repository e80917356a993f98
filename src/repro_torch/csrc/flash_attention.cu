// Online-softmax attention for prefill on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py:_flash_kernel
// (called by `flash_attention`, pallas_call at attention.py:109).  The port's
// ops.attention sends it every attention call with Tq >= 8 and no kv_len:
// the prefill of a from-scratch cache (prefill_fresh_kv) and a forward with
// no cache, on gemma2's local (window 4096) and global layers alike.
//
// What bounds it on an H100: at gemma2-9b's prefill (B 2, Hq 16, Hkv 8,
// T 4608, D 256) the work is 4*B*Hq*D operations per live query-key pair,
// ~3.5e11 per layer, against ~0.23 GB of q, k, v and output: ~1500
// operations per byte, far above the card's 295 in bf16.  The arithmetic
// units bound it, not device memory.
//
// Design.  One block of 256 threads per (64-row query tile, b*Hq + h).  The
// TPU kernel ran the key tiles as a sequential third grid axis, carried the
// running max, denominator and accumulator in VMEM scratch from one grid
// step to the next, and skipped dead tiles with pl.when; Hopper blocks run
// in no order, so here the block walks its key tiles in a loop, from the
// first to the last tile that the causal and window masks leave live for
// any of its rows.  Dead tiles are never loaded.  Each step stages a 64-key
// tile of K (transposed, d-major) and of V in shared memory as float32,
// computes the 64x64 logits with each thread owning a 4x4 register tile
// (rows ty + 16i, keys tx + 16j), scales, soft-caps, masks, and updates the
// float32 running max and denominator of its 4 rows; the 16 threads that
// share a row reduce with shuffles.  The probabilities go through shared
// memory into the P.V product, where each thread owns the same 4 rows and
// D/16 columns of the float32 accumulator.  GQA: the K/V head is
// h / group; K and V are never copied per query head.
//
// Masks.  Query rows are right-aligned (q_offset = Tk - Tq); a logit is
// kept when kpos < Tk, and qpos >= kpos if causal, and qpos - kpos < window
// if window > 0.  The masked value is the reference's finite -1e30, and the
// output divides by max(l, 1e-30), so a row whose first live tile masks
// all its keys gives exp(0) = 1 and no NaN (-INFINITY would give
// exp(-inf + inf)).  The kpos < Tk term is where this kernel departs from
// the TPU one: that kernel pads a ragged Tk with zero keys and masks them
// only through the causal test (attention.py:58-63 and 96-100), so without
// causal they enter the softmax.  Here they are never live, as in
// ref.attention.
//
// Shared memory: Q (D x 65) + K (D x 65) + V (64 x D) + P (64 x 65) float32,
// 215,296 bytes at D = 256, over the 48 KB default, so the launch raises
// the block's dynamic shared-memory limit first (one block per SM at
// D = 256, two at 128).  Registers: the D = 256 accumulator is 4 x 16
// floats a thread plus the 4 x 4 logit tile; the build's ptxas line shows
// whether that spills.  Types: bfloat16, float16 or float32 in, float32
// inside, output in the input type.  D is a template parameter: 16, 32, 64,
// 128 or 256; any other D returns -2.  This is the simple first version on
// the FMA units: no mma/wgmma, no TMA, no overlap of loads and math.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int TM = BQ / 16;   // query rows per thread (stride 16)
constexpr int TN = BK / 16;   // keys per thread (stride 16)
constexpr float NEG_INF = -1e30f;

// dtype codes shared with kernels/attention.py and kernels/decode_attention.py
enum Code { F32 = 0, BF16 = 2, F16 = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

template <int D>
constexpr int smem_floats() {
    return D * (BQ + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
             const T* __restrict__ V, T* __restrict__ O, int Hq, int group,
             int Tq, int Tk, long long qsb, long long qsh, long long qst,
             long long ksb, long long ksh, long long kst, long long vsb,
             long long vsh, long long vst, float scale, float softcap,
             int causal, int window) {
    constexpr int TD = D / 16;  // accumulator columns per thread (stride 16)
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                   // Qs[d * (BQ + 1) + r]
    float* Ks = Qs + D * (BQ + 1);      // Ks[d * (BK + 1) + c]
    float* Vs = Ks + D * (BK + 1);      // Vs[c * D + d]
    float* Ps = Vs + BK * D;            // Ps[r * (BK + 1) + c]

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int bh = blockIdx.y;
    const int b = bh / Hq, h = bh % Hq, hk = h / group;
    const int q0 = blockIdx.x * BQ;
    const int q_offset = Tk - Tq;
    Q += b * qsb + h * qsh;
    K += b * ksb + hk * ksh;
    V += b * vsb + hk * vsh;
    O += static_cast<long long>(bh) * Tq * D;

    for (int e = tid; e < BQ * D; e += THREADS) {
        const int r = e / D, d = e % D;
        Qs[d * (BQ + 1) + r] = (q0 + r < Tq) ? to_f(Q[(q0 + r) * qst + d]) : 0.f;
    }

    // keys live for some row of this tile: [k_lo, k_hi)
    const int qpos_first = q_offset + q0;
    const int qpos_last = q_offset + min(q0 + BQ, Tq) - 1;
    int k_lo = 0, k_hi = Tk;
    if (causal) k_hi = min(k_hi, qpos_last + 1);
    if (window > 0) k_lo = max(0, qpos_first - window + 1);
    const int t_lo = k_lo / BK;
    const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;

    float m[TM], l[TM], acc[TM][TD];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
    }

    for (int kt = t_lo; kt < t_hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // the last step's Ks, Vs and Ps are consumed
        for (int e = tid; e < BK * D; e += THREADS) {
            const int c = e / D, d = e % D;
            const bool ok = k0 + c < Tk;
            Ks[d * (BK + 1) + c] = ok ? to_f(K[(k0 + c) * kst + d]) : 0.f;
            Vs[c * D + d] = ok ? to_f(V[(k0 + c) * vst + d]) : 0.f;
        }
        __syncthreads();

        float s[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float a[TM], bk[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = Qs[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bk[j] = Ks[d * (BK + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int qpos = qpos_first + ty + 16 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int kpos = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
                bool ok = kpos < Tk;
                if (causal) ok = ok && qpos >= kpos;
                if (window > 0) ok = ok && qpos - kpos < window;
                s[i][j] = ok ? x : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const float p = expf(s[i][j] - m_new);
                Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float p[TM], v[TD];
#pragma unroll
            for (int i = 0; i < TM; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
            for (int j = 0; j < TD; ++j) v[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= Tq) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < TD; ++j) store(&O[r * D + tx + 16 * j], acc[i][j] * inv);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Tq, int Tk, const long long* qs,
           const long long* ks, const long long* vs, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
    const size_t smem = sizeof(float) * smem_floats<D>();
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&flash_kernel<T, D>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
    flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, Tq, Tk,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        scale, softcap, causal, window);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Hq, int Hkv, int Tq, int Tk, const long long* qs,
               const long long* ks, const long long* vs, float scale,
               float softcap, int causal, int window, cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        default: return -2;
    }
}

}  // namespace

// O = attention(Q, K, V): q is [B, Hq, Tq, D], k and v [B, Hkv, Tk, D], each
// with a unit stride on D and the element strides of b, h and t in
// qs/ks/vs; O is a contiguous [B, Hq, Tq, D] in the input type.  Returns
// cudaGetLastError() after the launch, -1 for a dtype the kernel does not
// take and -2 for a shape it cannot launch.
extern "C" int repro_flash_attention(int code, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int Tq, int Tk, int D,
                                     const long long* qs, const long long* ks,
                                     const long long* vs, float scale,
                                     float softcap, int causal, int window,
                                     void* stream) {
    if (B <= 0 || Hq <= 0 || Hkv <= 0 || Tq <= 0 || Tk <= 0) return -2;
    if (Hq % Hkv != 0 || B * Hq > 65535) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == F32)
        return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
    if (code == BF16)
        return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
    if (code == F16)
        return dispatch_d<__half>(D, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
    return -1;
}
