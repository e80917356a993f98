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
// ~3.5e11 per layer (0.35 ms on the tensor cores), against ~0.23 GB of q,
// k, v and output: ~1500 operations per byte, far above the card's 295 in
// bf16.  Second come the special-function units: each live logit costs
// three MUFU operations (ex2 and rcp for the soft-cap's tanh, ex2 for the
// softmax), ~1.0e9 per call, ~0.26 ms at their ~3.9e12 per second.
//
// Design: two paths, chosen by kernels/attention.py:plan from the dtype, D
// and the operands' layout, never as a fallback:
//
// 1. wgmma (bfloat16 and float16, D = 64, 128 or 256; FlashAttention-3's
//    shape).  One block of 384 threads per (128 query rows, b*Hq + h),
//    query tiles walked longest first (the grid's slowest index runs the
//    causal row tiles backwards).  A producer warpgroup (setmaxnreg 24)
//    keeps TMA loads of 64-key tiles of K and V (64 x D, in 8 KB boxes of
//    64 x 64, 128-byte swizzled) in a 2-stage ring under mbarriers, K and
//    V on barriers of their own; Q (64 rows per consumer) arrives once.
//    Two consumer warpgroups (setmaxnreg 240) own 64 query rows each:
//    S = Q.K^T is wgmma m64n64k16 with both operands K-major in shared
//    memory (D/16 k-steps); the online softmax runs in registers on the
//    accumulator layout (each thread holds 2 rows x 16 keys; the row max
//    takes two quad shuffles, the row sum is kept per thread and reduced
//    once at the end); P goes to the 16-bit type and into a 64 x 64
//    K-major tile of shared memory, swizzled as TMA would, and O += P.V is
//    wgmma m64nDk16 with B = V MN-major (V [keys, D] is contiguous along
//    D: the descriptor of csrc/gemm.cu's [K, N] weights).  O is 128
//    floats per thread at D = 256, where the consumer still spills and
//    ptxas then serializes every wgmma (chip_smoke.py's build lines
//    report wgmma and waits per variant; D 64 and 128 do not).  Within a
//    warpgroup, the softmax of tile n runs while P.V of tile n - 1 is in
//    flight; between the two, named barriers take turns issuing wgmma
//    (FA3's ping-pong), so one warpgroup's softmax can overlap the other's
//    tensor-core work.  Each wgmma region is straight-line code (the first
//    tile peeled, S zeroed by the instruction's scale-d): a branch or a
//    register write inside one also makes ptxas serialize it.
//    Logits are kept in log2 units with log2(e) folded into the scale; the
//    soft-cap is tanh(y) = 1 - 2 / (1 + 2^(2y log2 e)) on ex2.approx and
//    rcp.approx (absolute error a few 2^-23, ~1e-5 on a logit capped at
//    50; tanh.approx.f32's ~2^-11 relative would be ~0.025 there).  Masks
//    are computed only on tiles that straddle the causal diagonal, the
//    window's edge or a ragged Tk; interior tiles skip them.  Rows >= Tq
//    are never stored.  The one departure from the reference, which keeps
//    P in float32 (attention.py:70-75): P is rounded to the 16-bit type
//    for the tensor cores, and the denominator sums the same rounded P, so
//    a dominant key's rounding cancels; kernels/attention.py:
//    flash_tiles_plain is this arithmetic in plain PyTorch, and the CPU
//    tests hold it within 1e-2 per row of the reference.
// 2. FMA (float32, whose tolerance TF32 would miss, and D = 16 or 32 in
//    any type).  One block of 256 threads per (64-row query tile,
//    b*Hq + h); the block walks its live key tiles in a loop, staging a
//    64-key tile of K (transposed) and V in shared memory as float32,
//    computes the 64x64 logits with each thread owning a 4x4 register
//    tile, scales, soft-caps (tanhf), masks, and updates the running max
//    and denominator of its 4 rows; the probabilities go through shared
//    memory into the P.V product.  215 KB of shared memory at D = 256, so
//    one block per SM: this path is bound by the FMA units.
//
// Both paths: the TPU kernel ran the key tiles as a sequential third grid
// axis and carried the running max, denominator and accumulator in VMEM
// scratch; here a block loops over the key tiles that the causal and
// window masks leave live for any of its rows, and dead tiles are never
// loaded.  GQA: the K/V head is h / group (through the TMA coordinate on
// path 1); K and V are never copied per query head.  Query rows are
// right-aligned (q_offset = Tk - Tq); a logit is kept when kpos < Tk, and
// qpos >= kpos if causal, and qpos - kpos < window if window > 0.  The
// masked value is the reference's finite -1e30, and the output divides by
// max(l, 1e-30), so a row whose first live tile masks all its keys gives
// exp(0) = 1 and no NaN.  The kpos < Tk term is where this kernel departs
// from the TPU one: that kernel pads a ragged Tk with zero keys and masks
// them only through the causal test (attention.py:58-63 and 96-100), so
// without causal they enter the softmax.  Here they are never live, as in
// ref.attention.  Output in the input type.
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// Path 1: bf16/f16 on the tensor cores, wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int WG_BQ = 128;        // query rows per block: two consumer warpgroups
constexpr int WG_BK = 64;         // keys per tile
constexpr int WG_THREADS = 384;   // consumers 0-255, producer warpgroup 256-383
constexpr int CHUNK = 64 * 128;   // one TMA box: 64 rows x 64 16-bit values
constexpr float LOG2E = 1.4426950408889634f;
// setmaxnreg's caps: the producer warpgroup gives registers back (to 24),
// the two consumer warpgroups take them (with the launch's 168 per thread,
// 24 and 240 use the whole 64 K register file).  A probe build may set
// the consumers' cap lower (launch/flash_probe.py).
#ifndef FLASH_CONSUMER_REGS
#define FLASH_CONSUMER_REGS 240
#endif

// Q (two 64-row tiles), K and V (two stages each), P (one 64 x 64 tile per
// consumer warpgroup), 1 KB of alignment slack, 9 mbarriers
template <int D>
constexpr int wg_smem() { return (6 * (D / 64) + 2) * CHUNK + 1024 + 9 * 8; }

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_sync_n(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// two floats as one register of the 16-bit type (lo in the low half), and
// the sum of the two rounded values back in float
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    uint32_t u;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        u = *reinterpret_cast<uint32_t*>(&v);
    } else {
        __half2 v = __floats2half2_rn(lo, hi);
        u = *reinterpret_cast<uint32_t*>(&v);
    }
    return u;
}
template <typename T>
__device__ __forceinline__ float sum2(uint32_t u) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        return __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
    } else {
        const float2 f = __half22float2(*reinterpret_cast<__half2*>(&u));
        return f.x + f.y;
    }
}

struct Softmax {
    float c_lin, c_cap, c_out;    // scale log2(e); 2 log2(e) scale / cap; cap log2(e)
    int causal, window, Tk;
};

// The block's shared memory from `base`: Q (two 64-row tiles), K and V (two
// stages each), P (one tile per consumer warpgroup), then the mbarriers,
// all at constant offsets, so that one pointer register addresses them.
template <int D>
struct WgSmem {
    static constexpr int TILE = (D / 64) * CHUNK;
    unsigned char* base;
    __device__ unsigned char* q(int w) const { return base + w * TILE; }
    __device__ unsigned char* k(int st) const { return base + (2 + st) * TILE; }
    __device__ unsigned char* v(int st) const { return base + (4 + st) * TILE; }
    __device__ unsigned char* p(int w) const { return base + 6 * TILE + w * CHUNK; }
    __device__ uint64_t* bar(int i) const {
        return reinterpret_cast<uint64_t*>(base + 6 * TILE + 2 * CHUNK) + i;
    }
    __device__ uint64_t* q_full() const { return bar(0); }
    __device__ uint64_t* k_full(int st) const { return bar(1 + st); }
    __device__ uint64_t* k_empty(int st) const { return bar(3 + st); }
    __device__ uint64_t* v_full(int st) const { return bar(5 + st); }
    __device__ uint64_t* v_empty(int st) const { return bar(7 + st); }
};

// S = Q.K^T over D/16 k-steps, the first overwriting S (scale-d 0)
template <typename T, int D>
__device__ __forceinline__ void issue_s(float* s, uint64_t dq, uint64_t dk) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * CHUNK + (kk % 4) * 32) >> 4;
        wgmma_tile<T, 64, 0, 0>(s, dq + off, dk + off, kk > 0);
    }
}

// O += P.V over the tile's 64 keys, P K-major and V MN-major, in column
// slices of at most 128 (two 64-register accumulators at D = 256, which
// ptxas places more easily than one of 128)
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float* o, uint64_t dp, uint64_t dv) {
    constexpr int NP = D > 128 ? 128 : D;
#pragma unroll
    for (int h = 0; h < D / NP; ++h)
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
            wgmma_tile<T, NP, 0, 1>(o + h * NP / 2, dp + ((kk * 32) >> 4),
                                    dv + ((h * (NP / 64) * CHUNK + kk * 2048) >> 4));
}

// The online softmax of one tile, in place on S (this thread's rows r and
// r + 8, 16 keys each): logits in log2 units, soft-capped, masked where the
// tile straddles a mask edge, then exponentiated against the rows' new
// max; returns the factors a0, a1 that rescale the rows' running sums.
// Row r's live keys are the interval [lo, hi) of the tile's 64, so a mask
// costs one unsigned compare per logit: (c - lo) < (hi - lo).
template <bool CAP, bool EDGE>
__device__ __forceinline__ void softmax_tile(float* s, float& m0, float& m1, float& a0, float& a1,
                                             const Softmax& sm, int k0, int qp0, int t4) {
    // live keys of rows qp0 and qp0 + 8, relative to the tile's first key
    // and to this thread's first column 2 t4
    int lo0 = -k0 - 2 * t4, hi0 = sm.Tk - k0 - 2 * t4;
    if (sm.window > 0) lo0 = max(lo0, qp0 - sm.window + 1 - k0 - 2 * t4);
    if (sm.causal) hi0 = min(hi0, qp0 + 1 - k0 - 2 * t4);
    int lo1 = -k0 - 2 * t4, hi1 = sm.Tk - k0 - 2 * t4;
    if (sm.window > 0) lo1 = max(lo1, qp0 + 8 - sm.window + 1 - k0 - 2 * t4);
    if (sm.causal) hi1 = min(hi1, qp0 + 9 - k0 - 2 * t4);
    const unsigned w0 = static_cast<unsigned>(max(hi0 - lo0, 0));
    const unsigned w1 = static_cast<unsigned>(max(hi1 - lo1, 0));
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (CAP) x = sm.c_out - 2.f * sm.c_out * rcp(1.f + ex2(x * sm.c_cap));
            else x *= sm.c_lin;
            if (EDGE) {
                const int c = 8 * j + (e & 1);
                const bool ok = e < 2 ? static_cast<unsigned>(c - lo0) < w0
                                      : static_cast<unsigned>(c - lo1) < w1;
                x = ok ? x : NEG_INF;
            }
            s[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    a0 = ex2(m0 - n0);
    a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        s[4 * j + 0] = ex2(s[4 * j + 0] - n0);
        s[4 * j + 1] = ex2(s[4 * j + 1] - n0);
        s[4 * j + 2] = ex2(s[4 * j + 2] - n1);
        s[4 * j + 3] = ex2(s[4 * j + 3] - n1);
    }
}

// O and the running sums rescaled by a0, a1; P rounded to the 16-bit type
// and stored as the warpgroup's 64 x 64 K-major tile, 128-byte swizzled
// (row r's 16-byte piece c at r * 128 + (c ^ r % 8) * 16), the sums taking
// the same rounded P.  Rows r = 16 warp + g (+ 8), keys 8 j + 2 t4 (+ 1).
template <typename T, int D>
__device__ __forceinline__ void rescale_store_p(float* o, const float* s, unsigned char* P, int r,
                                                int t4, float a0, float a1, float& l0,
                                                float& l1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
    }
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint32_t u0 = pack2<T>(s[4 * j + 0], s[4 * j + 1]);
        const uint32_t u1 = pack2<T>(s[4 * j + 2], s[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(P + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t4) = u0;
        *reinterpret_cast<uint32_t*>(P + (r + 8) * 128 + ((j ^ ((r + 8) & 7)) << 4) + 4 * t4) = u1;
        r0 += sum2<T>(u0);
        r1 += sum2<T>(u1);
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
    // the stores are read by the next wgmma (the async proxy) of all four
    // warps: fence, then the warpgroup's own barrier
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One consumer warpgroup's 64 query rows over the block's live key tiles.
// The first tile is peeled, so that each wgmma region (S of tile n and P.V
// of tile n - 1, between a fence and a wait) is straight-line code.  P
// goes through shared memory rather than registers, which keeps 16 fewer
// registers live across the loop beside O's D / 2.
template <typename T, int D, bool CAP>
__device__ __forceinline__ void wg_consumer(const WgSmem<D> sh, T* O, const Softmax& sm, int w,
                                            int t_lo, int n_tiles, int q0, int Tq,
                                            int q_offset) {
    const int lt = threadIdx.x % 128, warp = lt / 32, g = (lt % 32) / 4, t4 = lt % 4;
    const int row = q0 + 64 * w + 16 * warp + g;          // and row + 8
    const int qp0 = q_offset + row;
    const int wq_lo = q_offset + q0 + 64 * w, wq_hi = wq_lo + 63;
    const int mine = 1 + w, other = 2 - w, own = 3 + w;
    const uint32_t sq = saddr(sh.q(w));
    unsigned char* P = sh.p(w);
    const int pr = 16 * warp + g;                        // P's rows pr, pr + 8
    auto edge = [&](int k0) {
        return k0 + WG_BK > sm.Tk || (sm.causal && k0 + WG_BK - 1 > wq_lo)
               || (sm.window > 0 && wq_hi - k0 >= sm.window);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, a0, a1;

    // tiles that straddle a mask edge form a prefix (the window's lower
    // edge) and a suffix (the causal diagonal, a ragged Tk) of the walk;
    // the interior runs a loop without mask code
    int lead = 0, tail = n_tiles;
    while (lead < n_tiles && edge((t_lo + lead) * WG_BK)) ++lead;
    while (tail > lead && edge((t_lo + tail - 1) * WG_BK)) --tail;

    if (w == 1) named_arrive(1);    // warpgroup 0 issues first
    mbar_wait(sh.q_full(), 0);
    if (n_tiles > 0) {
        mbar_wait(sh.k_full(0), 0);
        const uint64_t dq = make_desc(sq, true), dk = make_desc(saddr(sh.k(0)), true);
        named_sync(mine);
        wg_fence();
        issue_s<T, D>(s, dq, dk);
        wg_commit();
        named_arrive(other);
        wg_wait<0>();
        fence_regs<32>(s);
        mbar_arrive(sh.k_empty(0));
        const int k0 = t_lo * WG_BK;
        if (lead > 0 || tail == 0) softmax_tile<CAP, true>(s, m0, m1, a0, a1, sm, k0, qp0, t4);
        else softmax_tile<CAP, false>(s, m0, m1, a0, a1, sm, k0, qp0, t4);
        rescale_store_p<T, D>(o, s, P, pr, t4, a0, a1, l0, l1);
    }
    // S of tile n and P.V of tile n - 1, then tile n's softmax
    auto step = [&](int n, auto masked) {
        const int st = n & 1, k0 = (t_lo + n) * WG_BK;
        mbar_wait(sh.k_full(st), (n >> 1) & 1);
        mbar_wait(sh.v_full(st ^ 1), ((n - 1) >> 1) & 1);
        // descriptors from this iteration's base addresses (the empty asm
        // keeps the compiler from hoisting D/16 of them out of the loop);
        // k-steps add to the address field
        uint32_t sqn = sq;
        asm volatile("" : "+r"(sqn));
        const uint64_t dq = make_desc(sqn, true);
        const uint64_t dk = make_desc(saddr(sh.k(st)), true);
        const uint64_t dv = make_desc(saddr(sh.v(st ^ 1)), false);
        const uint64_t dp = make_desc(saddr(P), true);
        named_sync_n(own, 128);      // every warp's P is stored
        named_sync(mine);
        fence_regs<D / 2>(o);
        wg_fence();
        issue_s<T, D>(s, dq, dk);
        wg_commit();
        issue_pv<T, D>(o, dp, dv);
        wg_commit();
        named_arrive(other);
        wg_wait<1>();
        fence_regs<32>(s);
        mbar_arrive(sh.k_empty(st));
        softmax_tile<CAP, decltype(masked)::value>(s, m0, m1, a0, a1, sm, k0, qp0, t4);
        wg_wait<0>();
        fence_regs<D / 2>(o);
        mbar_arrive(sh.v_empty(st ^ 1));
        rescale_store_p<T, D>(o, s, P, pr, t4, a0, a1, l0, l1);
    };
    const int mid = max(lead, 1), end = max(tail, mid);
    for (int n = 1; n < mid && n < n_tiles; ++n) step(n, std::true_type());
    for (int n = mid; n < end; ++n) step(n, std::false_type());
    for (int n = end; n < n_tiles; ++n) step(n, std::true_type());
    if (n_tiles > 0) {
        // P.V of the last tile
        const int st = (n_tiles - 1) & 1;
        mbar_wait(sh.v_full(st), ((n_tiles - 1) >> 1) & 1);
        const uint64_t dv = make_desc(saddr(sh.v(st)), false);
        named_sync_n(own, 128);
        fence_regs<D / 2>(o);
        wg_fence();
        issue_pv<T, D>(o, make_desc(saddr(P), true), dv);
        wg_commit();
        wg_wait<0>();
        fence_regs<D / 2>(o);
        mbar_arrive(sh.v_empty(st));
    }
    if (w == 0) named_sync(1);      // warpgroup 1's last turn

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * t4;
        if (row < Tq)
            *reinterpret_cast<uint32_t*>(&O[static_cast<long long>(row) * D + c]) =
                pack2<T>(o[4 * j + 0] * i0, o[4 * j + 1] * i0);
        if (row + 8 < Tq)
            *reinterpret_cast<uint32_t*>(&O[static_cast<long long>(row + 8) * D + c]) =
                pack2<T>(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
}

template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, T* __restrict__ O, int Hq,
                   int group, int Tq, int n_qtiles, Softmax sm) {
    constexpr int NC = D / 64;
    constexpr int TILE = WgSmem<D>::TILE;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const WgSmem<D> sh{smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023)};

    const int tid = threadIdx.x, wg = tid / 128;
    const int heads = gridDim.x / n_qtiles;          // B * Hq
    const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / heads;
    const int bh = static_cast<int>(blockIdx.x) % heads;
    const int b = bh / Hq, h = bh % Hq, hk = h / group;
    const int q0 = qt * WG_BQ;
    const int q_offset = sm.Tk - Tq;
    const int qpos_first = q_offset + q0;
    const int qpos_last = q_offset + min(q0 + WG_BQ, Tq) - 1;
    int k_lo = 0, k_hi = sm.Tk;
    if (sm.causal) k_hi = min(k_hi, qpos_last + 1);
    if (sm.window > 0) k_lo = max(0, qpos_first - sm.window + 1);
    const int t_lo = k_lo / WG_BK;
    const int n_tiles = k_hi > k_lo ? (k_hi + WG_BK - 1) / WG_BK - t_lo : 0;

    if (tid == 0) {
        mbar_init(sh.q_full(), 1);
        for (int s = 0; s < 2; ++s) {
            mbar_init(sh.k_full(s), 1);
            mbar_init(sh.v_full(s), 1);
            mbar_init(sh.k_empty(s), 256);
            mbar_init(sh.v_empty(s), 256);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid == 256) {
            mbar_expect_tx(sh.q_full(), 2 * TILE);
            for (int w = 0; w < 2; ++w)
                for (int c = 0; c < NC; ++c)
                    tma_load4(sh.q(w) + c * CHUNK, &map_q, sh.q_full(), 64 * c, q0 + 64 * w, h, b);
            for (int n = 0; n < n_tiles; ++n) {
                const int st = n & 1, k0 = (t_lo + n) * WG_BK;
                if (n >= 2) mbar_wait(sh.k_empty(st), ((n >> 1) - 1) & 1);
                mbar_expect_tx(sh.k_full(st), TILE);
                for (int c = 0; c < NC; ++c)
                    tma_load4(sh.k(st) + c * CHUNK, &map_k, sh.k_full(st), 64 * c, k0, hk, b);
                if (n >= 2) mbar_wait(sh.v_empty(st), ((n >> 1) - 1) & 1);
                mbar_expect_tx(sh.v_full(st), TILE);
                for (int c = 0; c < NC; ++c)
                    tma_load4(sh.v(st) + c * CHUNK, &map_v, sh.v_full(st), 64 * c, k0, hk, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(FLASH_CONSUMER_REGS));
        wg_consumer<T, D, CAP>(sh, O + static_cast<long long>(bh) * Tq * D, sm, wg, t_lo,
                               n_tiles, q0, Tq, q_offset);
    }
}

// a 4-D map (D, T, H, B) of 16-bit elements with element strides st[0..2]
// of b, h, t; 64 x 64 boxes, 128-byte swizzle, zero fill past the edges
bool make_map4(CUtensorMap* map, int code, const void* p, int D, int T, int H, int B,
               const long long* st) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                   static_cast<cuuint64_t>(st[1]) * 2,
                                   static_cast<cuuint64_t>(st[0]) * 2};
    const cuuint32_t box[4] = {64, 64, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUtensorMapDataType dt = code == BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    return fn(map, dt, 4, const_cast<void*>(p), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the TMA rules: a 16-byte aligned base and 16-byte multiples for strides
bool tma_ok(const void* p, const long long* st) {
    return aligned16(p) && st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0
           && st[0] > 0 && st[1] > 0 && st[2] > 0;
}

template <typename T, int D>
int launch_wgmma(int code, const void* q, const void* k, const void* v, void* o, int B, int Hq,
                 int Hkv, int Tq, int Tk, const long long* qs, const long long* ks,
                 const long long* vs, float scale, float softcap, int causal, int window,
                 cudaStream_t stream) {
    CUtensorMap mq, mk, mv;
    if (!make_map4(&mq, code, q, D, Tq, Hq, B, qs) || !make_map4(&mk, code, k, D, Tk, Hkv, B, ks)
        || !make_map4(&mv, code, v, D, Tk, Hkv, B, vs))
        return -3;
    const int smem = wg_smem<D>();
    const bool cap = softcap > 0.f;
    auto kernel = cap ? &flash_wgmma_kernel<T, D, true> : &flash_wgmma_kernel<T, D, false>;
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Softmax sm;
    sm.c_lin = scale * LOG2E;
    sm.c_cap = cap ? 2.f * LOG2E * scale / softcap : 0.f;
    sm.c_out = softcap * LOG2E;
    sm.causal = causal;
    sm.window = window;
    sm.Tk = Tk;
    const int n_qtiles = (Tq + WG_BQ - 1) / WG_BQ;
    kernel<<<n_qtiles * B * Hq, WG_THREADS, smem, stream>>>(mq, mk, mv, static_cast<T*>(o), Hq,
                                                            Hq / Hkv, Tq, n_qtiles, sm);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(int code, int D, const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Tq, int Tk, const long long* qs, const long long* ks,
                   const long long* vs, float scale, float softcap, int causal, int window,
                   cudaStream_t s) {
    switch (D) {
        case 64: return launch_wgmma<T, 64>(code, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        case 128: return launch_wgmma<T, 128>(code, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
        case 256: return launch_wgmma<T, 256>(code, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
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

#ifdef REPRO_TRAP_RECORD
// A probe build's: where the first mbarrier wait that runs out records
// itself before it traps (see hopper.cuh), host memory mapped for the
// card; 0 when the record was set.
extern "C" int repro_set_trap_record(void* host) { return set_trap_record(host); }
#endif

// Path 1 of the same function for bfloat16/float16 q, k, v with D = 64, 128
// or 256 whose base pointers are 16-byte aligned and whose b, h, t strides
// are positive multiples of 8 elements (the TMA rules; kernels/attention.py:
// plan copies an operand that breaks them).  O is a contiguous [B, Hq, Tq,
// D].  Returns cudaGetLastError() after the launch, -1 for a dtype the path
// does not take, -2 for a shape or layout it cannot launch and -3 when the
// tensor maps cannot be made.
extern "C" int repro_flash_attention_wgmma(int code, const void* q, const void* k,
                                           const void* v, void* o, int B, int Hq, int Hkv,
                                           int Tq, int Tk, int D, const long long* qs,
                                           const long long* ks, const long long* vs,
                                           float scale, float softcap, int causal, int window,
                                           void* stream) {
    if (B <= 0 || Hq <= 0 || Hkv <= 0 || Tq <= 0 || Tk <= 0 || Hq % Hkv != 0) return -2;
    if (static_cast<long long>((Tq + WG_BQ - 1) / WG_BQ) * B * Hq >= (1ll << 31)) return -2;
    if (!tma_ok(q, qs) || !tma_ok(k, ks) || !tma_ok(v, vs)) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == BF16)
        return dispatch_wgmma<__nv_bfloat16>(code, D, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
    if (code == F16)
        return dispatch_wgmma<__half>(code, D, q, k, v, o, B, Hq, Hkv, Tq, Tk, qs, ks, vs, scale, softcap, causal, window, s);
    return -1;
}
