// Single-token attention against a decode cache on Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py:_decode_kernel (called by
// `decode_attention`, pallas_call at decode_attention.py:96).  The port's
// ops.attention sends it every decode step of a causal layer without a
// window (gemma2's global layers): one new query token per (b, query head)
// against the live prefix kv_len of a [B, Hkv, S, D] cache.
//
// What bounds it on an H100: device memory.  Each live key and value is
// read once and used for Hq/Hkv query rows: 4*Hq*D operations per key
// position against 4*Hkv*D bytes of bf16 K and V, about 2 operations per
// byte, two orders below the card's 295.  At gemma2-9b's serve shape
// (B 2, Hkv 8, D 256, kv_len 4609) that is 75.5 MB, ~0.0225 ms at
// 3.35 TB/s.
//
// Design.  One block per (b, KV head) would give the card B*Hkv = 16 blocks
// for 132 SMs, so the keys are split: pass 1 runs one block of 256 threads
// per (256-key chunk of [0, kv_len), b, KV head), 19 x 16 = 304 blocks at
// the serve shape, and writes each query row's float32 running max m,
// denominator l and unnormalized accumulator (D floats) to a scratch
// buffer that the wrapper allocates; pass 2 runs one block per (b, query
// head) that rescales the chunks to their common max and divides by
// max(l, 1e-30).  The TPU kernel instead walked all key blocks as a
// sequential grid axis with the state in VMEM, and skipped blocks past
// kv_len with pl.when.  Here kv_len comes by value, the grid covers only
// the live chunks, the key loop stops at kv_len and the last partial tile
// is masked: no key at or past kv_len is loaded or counted.
//
// Inside a chunk the block walks 64-key tiles.  Logits: each warp takes
// every eighth key, each lane holds D/32 elements of the key row, and the
// GQA group's Hq/Hkv query rows (kept in shared memory as float32) all use
// that one load of K; a shuffle reduction gives each row's dot product,
// which is scaled and soft-capped (tanh(x / c) * c).  Softmax: one warp per
// query row updates its running max and denominator and turns the logits
// into probabilities in shared memory.  P.V: thread t owns column t of the
// accumulator for every row of the group, reading V row by row, each value
// once.  Masked logits take the reference's finite -1e30.  Types: bfloat16,
// float16 or float32 in, float32 inside, output in the input type.  D is
// 16, 32, 64, 128 or 256 and the group at most 8; anything else returns -2.
// This is the simple first version: scalar loads, no vectorized or
// asynchronous copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int BK = 64;          // keys per tile
constexpr int CHUNK = 256;      // keys per block of pass 1
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;         // query rows per KV head
constexpr float NEG_INF = -1e30f;

// dtype codes shared with kernels/attention.py and kernels/decode_attention.py
enum Code { F32 = 0, BF16 = 2, F16 = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Pass 1.  part holds, per (b, query head, chunk): m, l, then D floats of
// the unnormalized accumulator.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                      const T* __restrict__ V, float* __restrict__ part,
                      int Hkv, int group, int kv_len, int n_chunks,
                      long long qsb, long long qsh, long long ksb,
                      long long ksh, long long kst, long long vsb,
                      long long vsh, long long vst, float scale,
                      float softcap) {
    constexpr int PER_LANE = (D + 31) / 32;
    __shared__ float qs[MAXG][D];
    __shared__ float ps[MAXG][BK];
    __shared__ float alpha_s[MAXG];

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int chunk = blockIdx.x;
    const int bh = blockIdx.y;              // b * Hkv + kv head
    const int b = bh / Hkv, hk = bh % Hkv;
    const int h0 = hk * group;              // first query head of the group
    K += b * ksb + hk * ksh;
    V += b * vsb + hk * vsh;
    for (int e = tid; e < group * D; e += THREADS) {
        const int g = e / D, d = e % D;
        qs[g][d] = to_f(Q[b * qsb + (h0 + g) * qsh + d]);
    }

    const int c0 = chunk * CHUNK;
    const int c1 = min(c0 + CHUNK, kv_len);
    // warp g keeps row g's running max and denominator (group <= WARPS);
    // thread t < D keeps column t of every row's accumulator
    float m_run = NEG_INF, l_run = 0.f, acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

    for (int k0 = c0; k0 < c1; k0 += BK) {
        const int nk = min(BK, c1 - k0);
        __syncthreads();   // qs written / the last tile's ps consumed
        for (int kk = warp; kk < BK; kk += WARPS) {
            if (kk >= nk) {                 // past kv_len: masked, not loaded
                if (lane < group) ps[lane][kk] = NEG_INF;
                continue;
            }
            float kr[PER_LANE];
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                const int d = lane + 32 * j;
                kr[j] = d < D ? to_f(K[(k0 + kk) * kst + d]) : 0.f;
            }
            for (int g = 0; g < group; ++g) {
                float dot = 0.f;
#pragma unroll
                for (int j = 0; j < PER_LANE; ++j) {
                    const int d = lane + 32 * j;
                    if (d < D) dot = fmaf(qs[g][d], kr[j], dot);
                }
                dot = warp_sum(dot);
                if (lane == 0) {
                    float x = dot * scale;
                    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
                    ps[g][kk] = x;
                }
            }
        }
        __syncthreads();
        if (warp < group) {
            const int g = warp;
            const float x0 = ps[g][lane], x1 = ps[g][lane + 32];
            const float m_new = fmaxf(m_run, warp_max(fmaxf(x0, x1)));
            const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
            ps[g][lane] = p0;
            ps[g][lane + 32] = p1;
            const float alpha = expf(m_run - m_new);
            l_run = l_run * alpha + warp_sum(p0 + p1);
            m_run = m_new;
            if (lane == 0) alpha_s[g] = alpha;
        }
        __syncthreads();
        if (tid < D) {
            float a[MAXG];
#pragma unroll
            for (int g = 0; g < MAXG; ++g) a[g] = 0.f;
            for (int kk = 0; kk < nk; ++kk) {
                const float v = to_f(V[(k0 + kk) * vst + tid]);
#pragma unroll
                for (int g = 0; g < MAXG; ++g)
                    if (g < group) a[g] = fmaf(ps[g][kk], v, a[g]);
            }
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
                if (g < group) acc[g] = acc[g] * alpha_s[g] + a[g];
        }
    }

    const long long row0 = static_cast<long long>(b) * Hkv * group + h0;
    if (warp < group && lane == 0) {
        float* out = part + ((row0 + warp) * n_chunks + chunk) * (D + 2);
        out[0] = m_run;
        out[1] = l_run;
    }
    if (tid < D) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
            if (g < group)
                part[((row0 + g) * n_chunks + chunk) * (D + 2) + 2 + tid] = acc[g];
    }
}

// Pass 2: one block of D threads per (b, query head).
template <typename T, int D>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ O, int n_chunks) {
    const int row = blockIdx.x;             // b * Hq + h
    const float* p = part + static_cast<long long>(row) * n_chunks * (D + 2);
    float m = NEG_INF;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, p[c * (D + 2)]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
        const float w = expf(p[c * (D + 2)] - m);
        l = fmaf(p[c * (D + 2) + 1], w, l);
        acc = fmaf(p[c * (D + 2) + 2 + threadIdx.x], w, acc);
    }
    store(&O[static_cast<long long>(row) * D + threadIdx.x], acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* part,
           int B, int Hq, int Hkv, int kv_len, const long long* qs,
           const long long* ks, const long long* vs, float scale,
           float softcap, cudaStream_t stream) {
    const int n_chunks = (kv_len + CHUNK - 1) / CHUNK;
    dim3 grid(n_chunks, B * Hkv);
    decode_partial_kernel<T, D><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), part, Hkv, Hq / Hkv, kv_len, n_chunks,
        qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale,
        softcap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_combine_kernel<T, D><<<B * Hq, D, 0, stream>>>(
        part, static_cast<T*>(o), n_chunks);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* part, int B, int Hq, int Hkv, int kv_len,
               const long long* qs, const long long* ks, const long long* vs,
               float scale, float softcap, cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, part, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
        case 32: return launch<T, 32>(q, k, v, o, part, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
        case 64: return launch<T, 64>(q, k, v, o, part, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
        case 128: return launch<T, 128>(q, k, v, o, part, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
        case 256: return launch<T, 256>(q, k, v, o, part, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
        default: return -2;
    }
}

}  // namespace

// Number of float32 scratch values repro_decode_attention needs for B*Hq
// query rows at kv_len: (D + 2) per row and 256-key chunk.
extern "C" long long repro_decode_scratch(int B, int Hq, int D, int kv_len) {
    const long long n_chunks = (kv_len + CHUNK - 1) / CHUNK;
    return static_cast<long long>(B) * Hq * n_chunks * (D + 2);
}

// O = attention of one query token per (b, h) against keys [0, kv_len) of
// the cache: q is [B, Hq, 1, D], k and v [B, Hkv, S, D] with kv_len <= S,
// each with a unit stride on D and the element strides of b and h (and t
// for k and v) in qs/ks/vs; O is a contiguous [B, Hq, 1, D] in the input
// type; part is float32 scratch of repro_decode_scratch() values.  Returns
// cudaGetLastError() after the launches, -1 for a dtype the kernel does not
// take and -2 for a shape it cannot launch.
extern "C" int repro_decode_attention(int code, const void* q, const void* k,
                                      const void* v, void* o, void* part,
                                      int B, int Hq, int Hkv, int S, int D,
                                      int kv_len, const long long* qs,
                                      const long long* ks, const long long* vs,
                                      float scale, float softcap,
                                      void* stream) {
    if (B <= 0 || Hq <= 0 || Hkv <= 0 || kv_len <= 0 || kv_len > S) return -2;
    if (Hq % Hkv != 0 || Hq / Hkv > MAXG || B * Hkv > 65535) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* p = static_cast<float*>(part);
    if (code == F32)
        return dispatch_d<float>(D, q, k, v, o, p, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
    if (code == BF16)
        return dispatch_d<__nv_bfloat16>(D, q, k, v, o, p, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
    if (code == F16)
        return dispatch_d<__half>(D, q, k, v, o, p, B, Hq, Hkv, kv_len, qs, ks, vs, scale, softcap, s);
    return -1;
}
