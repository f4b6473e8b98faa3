// K-NB: the Wild noise blanker's LPC fit, impulse search and repairs.
//
// Replaces the serial parts of nb_process (phantomsdr_tpu/ops/nb.py,
// jsdsp/lib/NB.c): launch 1 (nb_lpc) fits the frame's LPC model and
// folds the il-step prediction recursions (the lax.scans of nb.py:188
// and :195) into [il, order] matrices; the two FIR passes run between
// the launches as grouped conv1d in PyTorch; launch 2 (nb_repair)
// thresholds the residual, runs the greedy impulse search (nb.py:161)
// and the sequential repairs (nb.py:255), and writes the repaired
// working buffer.
//
// The working buffer of a channel is wb = the carried 2*order + 2*PL
// samples ++ the step's t samples; the frame is base = wb[order+PL ..
// order+PL+t), and the residual temp [t] comes from the FIRs.
//
// Bound: bytes (wb and temp read, the repaired buffer written: ~10 MB at
// the bench shape, 128 channels x 6480 samples); what does not spread
// over threads is Levinson (order^2/2 steps), the 2 x il recursion
// steps and the repair chain of up to 20 slots.
//
// Design, one block of 256 threads per channel in each launch:
// - nb_lpc: the block stages base in tiles of 256 + order samples in
//   shared memory and each thread accumulates its samples' products for
//   all order+1 lags in registers; warp shuffles and one exchange reduce
//   them.  Thread 0 runs Levinson-Durbin as transcribed (R[0] * (1 +
//   1e-9), which is R[0] in float32).  Then order threads run the
//   forward recursion, one prediction row a step, then the backward one
//   (the identity part of each basis is implicit).
// - nb_repair: block reductions give the mean and the unbiased
//   variance of temp; threshold = thresh * sqrt(sigma2 * lpc_power),
//   lpc_power = sum of lpcs[0..order-1]^2 (NB.c:177).  The 8 warps
//   ballot |temp| > threshold over the search positions order+PL .. t-1
//   into bit masks in shared memory, and warp 0 walks the set bits in
//   order (select where pos >= next and count < 20; next = pos + PL + 1),
//   uniformly in all its lanes.  This gives the positions of JAX's
//   search over its top_k-compacted candidates.  The block copies wb
//   to the output buffer; then per slot, il threads each predict one
//   sample of the window forward from the output buffer (which holds
//   the earlier repairs) and backward from wb (which no earlier repair
//   reaches), crossfade them and store into the output buffer.  The
//   forward basis is read as orig + (repaired - orig), the JAX
//   package's correction arithmetic.
// Arithmetic: fmaf in the long sums; the Levinson steps, the threshold
// and the crossfade with round-to-nearest intrinsics in the JAX order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOrder = 40;  // NB.c:19 max_lpc_order
constexpr int kSlots = 20;     // N_IMPULSE_COUNT
constexpr int kMaxSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(0xffffffffu, v, k);
    return v;
}

// Sum of v over the block (every thread gets it); red: kWarps floats.
__device__ float block_sum(float v, float* red) {
    v = warp_sum(v);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // red is free
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    return s;
}

// ---------------------------------------------------------------- nb_lpc

__global__ void __launch_bounds__(kThreads)
nb_lpc_kernel(const float* __restrict__ wb, float* __restrict__ lpcs_out,
              float* __restrict__ coef_f, float* __restrict__ coef_b_rev, int wlen, int t,
              int order, int il) {
    extern __shared__ float smem[];
    const int pl = (il - 1) / 2;
    const int tile_len = kThreads + order;
    float* tile = smem;                          // [256 + order]
    float* red = tile + tile_len;                // [(order+1) * kWarps]
    float* r = red + (order + 1) * kWarps;       // [order+1]
    float* lpcs = r + order + 1;                 // [order+1]
    float* tmp = lpcs + order + 1;               // [order+1]
    float* pred = tmp + order + 1;               // [order] fwd, then bwd taps
    float* rows = pred + order;                  // [il * order]
    const int c = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* base = wb + static_cast<long long>(c) * wlen + order + pl;

    // 1. lags r_i = sum_n base[n] base[n+i], n + i < t
    float acc[kMaxOrder + 1];
#pragma unroll
    for (int i = 0; i <= kMaxOrder; ++i) acc[i] = 0.0f;
    for (int s0 = 0; s0 < t; s0 += kThreads) {
        __syncthreads();
        for (int j = tid; j < tile_len; j += kThreads)
            tile[j] = s0 + j < t ? base[s0 + j] : 0.0f;
        __syncthreads();
        const float xn = tile[tid];
#pragma unroll
        for (int i = 0; i <= kMaxOrder; ++i)
            if (i <= order) acc[i] = fmaf(xn, tile[tid + i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i <= kMaxOrder; ++i) {
        if (i <= order) {
            const float v = warp_sum(acc[i]);
            if (lane == 0) red[i * kWarps + warp] = v;
        }
    }
    __syncthreads();
    if (tid <= order) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += red[tid * kWarps + w];
        r[tid] = s;
    }
    __syncthreads();

    // 2. Levinson-Durbin (NB.c:120-148), one thread
    if (tid == 0) {
        lpcs[0] = 1.0f;
        for (int m = 1; m <= order; ++m) lpcs[m] = 0.0f;
        float alfa = __fmul_rn(r[0], 1.0f + 1.0e-9f);
        for (int m = 1; m <= order; ++m) {
            float s = 0.0f;
            for (int u = 1; u < m; ++u) s = __fadd_rn(s, __fmul_rn(lpcs[u], r[m - u]));
            const float k = __fdiv_rn(-__fadd_rn(r[m], s), alfa);
            for (int u = 1; u < m; ++u)
                tmp[u] = __fadd_rn(lpcs[u], __fmul_rn(k, lpcs[m - u]));
            for (int u = 1; u < m; ++u) lpcs[u] = tmp[u];
            lpcs[m] = k;
            alfa = __fmul_rn(alfa, __fsub_rn(1.0f, __fmul_rn(k, k)));
        }
    }
    __syncthreads();
    for (int m = tid; m <= order; m += kThreads)
        lpcs_out[static_cast<long long>(c) * (order + 1) + m] = lpcs[m];

    // 3. forward: basis rows i..i+order-1 of [eye; rows], step i's row
    // is sum_o fwd[o] * basis[i+o], fwd = -(lpcs[order], ..., lpcs[1])
    float* cf = coef_f + static_cast<long long>(c) * il * order;
    if (tid < order) pred[tid] = -lpcs[order - tid];
    __syncthreads();
    for (int i = 0; i < il; ++i) {
        if (tid < order) {
            float v = 0.0f;
            for (int o = 0; o < order; ++o) {
                const int b = i + o;
                const float bv = b < order ? (b == tid ? 1.0f : 0.0f)
                                           : rows[(b - order) * order + tid];
                v = fmaf(pred[o], bv, v);
            }
            rows[i * order + tid] = v;
            cf[i * order + tid] = v;
        }
        __syncthreads();
    }
    // backward: step i's row is sum_o bwd[o] * basis_i[o], basis_i =
    // (rows i-1, ..., 0, then eye rows 0, 1, ...), bwd = -(lpcs[1], ...,
    // lpcs[order]); coef_b_rev[i'] is step il-1-i'
    float* cb = coef_b_rev + static_cast<long long>(c) * il * order;
    if (tid < order) pred[tid] = -lpcs[1 + tid];
    __syncthreads();
    for (int i = 0; i < il; ++i) {
        if (tid < order) {
            float v = 0.0f;
            for (int o = 0; o < order; ++o) {
                const float bv = o >= i ? (o - i == tid ? 1.0f : 0.0f)
                                        : rows[(i - 1 - o) * order + tid];
                v = fmaf(pred[o], bv, v);
            }
            rows[i * order + tid] = v;
            cb[(il - 1 - i) * order + tid] = v;
        }
        __syncthreads();
    }
}

// ------------------------------------------------------------- nb_repair

template <bool kProbe>
__global__ void __launch_bounds__(kThreads)
nb_repair_kernel(const float* __restrict__ wb, const float* __restrict__ temp,
                 const float* __restrict__ lpcs, const float* __restrict__ coef_f,
                 const float* __restrict__ coef_b_rev, float* __restrict__ wbf,
                 int* __restrict__ count_out, int* __restrict__ positions_out,
                 float* __restrict__ thr_out, int wlen, int t, int order, int il,
                 float thresh) {
    extern __shared__ uint32_t masks[];          // [nwords]
    __shared__ float red[kWarps];
    __shared__ int pos_s[kSlots];
    __shared__ int count_s;
    __shared__ float thr_s;
    const int pl = (il - 1) / 2;
    const int c = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* orig = wb + static_cast<long long>(c) * wlen;
    float* out = wbf + static_cast<long long>(c) * wlen;
    const float* res = temp + static_cast<long long>(c) * t;
    const int lo = order + pl;
    const int nwords = t > lo ? (t - lo + 31) / 32 : 0;

    if (kProbe) {
        // the densest chain the search can give: 20 slots PL + 1 apart
        if (tid < kSlots) pos_s[tid] = pl + tid * (pl + 1);
        if (tid == 0) count_s = kSlots;
    } else {
        // 1. threshold (nb.py:125-129)
        float s = 0.0f;
        for (int n = tid; n < t; n += kThreads) s += res[n];
        const float mean = __fdiv_rn(block_sum(s, red), static_cast<float>(t));
        float s2 = 0.0f;
        for (int n = tid; n < t; n += kThreads) {
            const float d = __fsub_rn(res[n], mean);
            s2 = fmaf(d, d, s2);
        }
        const float sigma2 = __fdiv_rn(block_sum(s2, red), static_cast<float>(t - 1));
        if (tid == 0) {
            const float* lp = lpcs + static_cast<long long>(c) * (order + 1);
            float power = 0.0f;
            for (int k = 0; k < order; ++k) power = __fadd_rn(power, __fmul_rn(lp[k], lp[k]));
            thr_s = __fmul_rn(thresh, __fsqrt_rn(__fmul_rn(sigma2, power)));
        }
        __syncthreads();
        const float thr = thr_s;
        // 2. candidates as bit masks, 32 positions a word
        for (int w = warp; w < nwords; w += kWarps) {
            const int pos = lo + w * 32 + lane;
            const bool hit = pos < t && fabsf(res[pos]) > thr;
            const uint32_t m = __ballot_sync(0xffffffffu, hit);
            if (lane == 0) masks[w] = m;
        }
        __syncthreads();
        // 3. greedy search, uniform across warp 0's lanes
        if (warp == 0) {
            int cnt = 0, nxt = lo;
            for (int w = 0; w < nwords && cnt < kSlots; ++w) {
                uint32_t m = masks[w];
                while (m != 0u && cnt < kSlots) {
                    const int p = lo + w * 32 + __ffs(static_cast<int>(m)) - 1;
                    m &= m - 1u;
                    if (p >= nxt) {
                        if (lane == 0) pos_s[cnt] = p - order;
                        ++cnt;
                        nxt = p + pl + 1;
                    }
                }
            }
            if (lane == 0) count_s = cnt;
        }
        // 4. the output buffer starts as wb
        for (int n = tid; n < wlen; n += kThreads) out[n] = orig[n];
        __syncthreads();
    }
    __syncthreads();

    // 5. repairs, slot after slot (NB.c:205-245)
    const int cnt = count_s;
    const float* cfc = coef_f + static_cast<long long>(c) * il * order;
    const float* cbc = coef_b_rev + static_cast<long long>(c) * il * order;
    const float wbw = tid < il ? __fdiv_rn(static_cast<float>(tid), static_cast<float>(il - 1))
                               : 0.0f;
    const float wfw = tid < il ? __fdiv_rn(static_cast<float>(il - 1 - tid),
                                           static_cast<float>(il - 1))
                               : 0.0f;
    for (int j = 0; j < cnt; ++j) {
        const int p = pos_s[j];
        if (tid < il) {
            float fp = 0.0f, bp = 0.0f;
            const float* rf = cfc + tid * order;
            const float* rb = cbc + tid * order;
            for (int o = 0; o < order; ++o) {
                const float v0 = orig[p + o];
                const float v = __fadd_rn(v0, __fsub_rn(out[p + o], v0));
                fp = fmaf(rf[o], v, fp);
                bp = fmaf(rb[o], orig[p + order + il + o], bp);
            }
            out[p + order + tid] = __fadd_rn(__fmul_rn(wfw, fp), __fmul_rn(wbw, bp));
        }
        __syncthreads();
    }
    if (!kProbe) {
        if (tid < kSlots) positions_out[c * kSlots + tid] = tid < cnt ? pos_s[tid] : 0;
        if (tid == 0) {
            count_out[c] = cnt;
            thr_out[c] = thr_s;
        }
    }
}

size_t lpc_smem(int order, int il) {
    return sizeof(float) * (static_cast<size_t>(kThreads) + order + (order + 1) * kWarps +
                            3 * (order + 1) + order + static_cast<size_t>(il) * order);
}

size_t repair_smem(int t, int order, int il) {
    const int lo = order + (il - 1) / 2;
    return sizeof(uint32_t) * static_cast<size_t>(t > lo ? (t - lo + 31) / 32 : 0);
}

template <bool kProbe>
int repair_launch(const float* wb, const float* temp, const float* lpcs, const float* coef_f,
                  const float* coef_b_rev, float* wbf, int* count, int* positions, float* thr,
                  int channels, int wlen, int t, int order, int il, float thresh, int device,
                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    if (order < 1 || order > kMaxOrder || il < 3 || il > kThreads)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = repair_smem(t, order, il);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    nb_repair_kernel<kProbe><<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wb, temp, lpcs, coef_f, coef_b_rev, wbf, count, positions, thr, wlen, t, order, il,
        thresh);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wb: [channels, wlen] float32 (wlen = t + 2*order + 2*PL); lpcs:
// [channels, order+1]; coef_f, coef_b_rev: [channels, il, order].
extern "C" int nb_lpc_launch(const float* wb, float* lpcs, float* coef_f, float* coef_b_rev,
                             int channels, int wlen, int t, int order, int il, int device,
                             void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    if (order < 1 || order > kMaxOrder || il < 3) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = lpc_smem(order, il);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    nb_lpc_kernel<<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wb, lpcs, coef_f, coef_b_rev, wlen, t, order, il);
    return static_cast<int>(cudaGetLastError());
}

// temp: [channels, t] float32 residual; wbf: [channels, wlen] output;
// count: [channels] int32; positions: [channels, 20] int32; thr:
// [channels] float32.
extern "C" int nb_repair_launch(const float* wb, const float* temp, const float* lpcs,
                                const float* coef_f, const float* coef_b_rev, float* wbf,
                                int* count, int* positions, float* thr, int channels, int wlen,
                                int t, int order, int il, float thresh, int device,
                                void* stream) {
    return repair_launch<false>(wb, temp, lpcs, coef_f, coef_b_rev, wbf, count, positions, thr,
                                channels, wlen, t, order, il, thresh, device, stream);
}

// The repair chain alone over 20 slots PL + 1 apart; wbf must hold wb.
extern "C" int nb_repair_chain_probe_launch(const float* wb, const float* coef_f,
                                            const float* coef_b_rev, float* wbf,
                                            const float* temp, int channels, int wlen, int t,
                                            int order, int il, int device, void* stream) {
    const int pl = (il - 1) / 2;
    if ((pl + (kSlots - 1) * (pl + 1)) + 2 * order + il > wlen)
        return static_cast<int>(cudaErrorInvalidValue);
    return repair_launch<true>(wb, temp, nullptr, coef_f, coef_b_rev, wbf, nullptr, nullptr,
                               nullptr, channels, wlen, t, order, il, 0.0f, device, stream);
}
