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
// - nb_lpc: the frame streams through two shared-memory chunks of 2048
//   + order samples by cp.async, the next in flight while the block
//   works on the current one (one barrier pair a chunk).  Each thread
//   accumulates the products of its samples (n = tid mod 256) for every
//   lag up to 40 in registers (no branch, so the loads run ahead); warp
//   shuffles and one exchange reduce the order+1 it needs.  Warp 0 runs
//   Levinson-Durbin as transcribed (R[0] * (1 + 1e-9), which is R[0] in
//   float32) with lpcs and r in registers, its steps unrolled so that
//   every index is known when compiling: no shared-memory round trip in
//   its order^2 dependent operations.  Then warp 0 runs the forward
//   recursion and warp 1 the backward one, lane u owning columns u and
//   u+32: a column of the il-step recursion depends only on the
//   column's own earlier rows, so each lane keeps its last order rows
//   in registers and the steps need no barrier at all.
// Runtime bounds inside unrolled loops (order) became branches that kept
// the loads from running ahead, so the unrolled sums run to 40 in
// groups of 8 with zero terms past order, which add +0 exactly to sums
// that start at +0 (such a sum is never -0).
// - nb_repair: the residual is read once (into shared memory where it
//   fits beside the rest) for the mean, the unbiased variance and the
//   ballot, each in its per-thread order as before; threshold = thresh *
//   sqrt(sigma2 * lpc_power), lpc_power = sum of lpcs[0..order-1]^2
//   (NB.c:177) added in order by warp 0 from shuffles.  The 8 warps
//   ballot |temp| > threshold over the search positions order+PL .. t-1
//   into bit masks, and warp 0 walks the set bits in order (select
//   where pos >= next and count < 20; next = pos + PL + 1), 32 words at
//   a time, uniformly in all its lanes.  This gives the positions of
//   JAX's search over its top_k-compacted candidates.  Each slot's span
//   wb[p .. p + 2*order + il) is staged into a compact buffer where
//   overlapping spans share their samples (span j starts min(p_j -
//   p_{j-1}, span) after span j-1), twice: the original and the current
//   samples.  The backward predictions read only original samples, so
//   all slots' come first, in parallel; then the chain: slot after slot,
//   il threads each predict one sample of the window forward (their
//   coef_f rows in registers; the basis orig + (current - orig), the JAX
//   package's correction arithmetic, all loaded before the sum),
//   crossfade and store it into the current samples, with a warp barrier
//   (a named one past 32 threads) between slots.  One coalesced pass
//   then writes the repaired buffer: a sample inside a span from the
//   current samples, any other from wb (8 loads in flight a thread).
// Arithmetic: fmaf in the long sums; the Levinson steps, the threshold
// and the crossfade with round-to-nearest intrinsics in the JAX order.
// Every sum keeps one order whatever the thread layout, so the outputs
// are the same bit for bit as those of the earlier tile-staged kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOrder = 40;  // NB.c:19 max_lpc_order
constexpr int kSlots = 20;     // N_IMPULSE_COUNT
constexpr int kChunk = 2048;   // frame samples per staged chunk of the lag sums
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kChunk % kThreads == 0, "a chunk keeps each thread's samples n = tid mod 256");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(kAll, v, k);
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
    __shared__ __align__(16) float buf[2][kChunk + kMaxOrder];
    __shared__ float red[(kMaxOrder + 1) * kWarps];
    __shared__ float r[kMaxOrder + 1];
    __shared__ float lp[kMaxOrder + 1];
    const int pl = (il - 1) / 2;
    const int c = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* base = wb + static_cast<long long>(c) * wlen + order + pl;

    // 1. lags r_i = sum_n base[n] base[n+i], n + i < t: each thread's
    // samples n = tid mod 256 below t rounded up to 256 (zero past t)
    const int tpad = (t + kThreads - 1) / kThreads * kThreads;
    const int chunks = (tpad + kChunk - 1) / kChunk;
    auto stage = [&](int k) {
        float* dst = buf[k & 1];
        for (int j = tid; j < kChunk + order; j += kThreads) {
            const int n = k * kChunk + j;
            if (n < t)
                cp_async4(dst + j, base + n);
            else
                dst[j] = 0.0f;
        }
    };
    float acc[kMaxOrder + 1];
#pragma unroll
    for (int i = 0; i <= kMaxOrder; ++i) acc[i] = 0.0f;
    if (chunks > 0) stage(0);
    cp_async_commit();
    for (int k = 0; k < chunks; ++k) {
        if (k + 1 < chunks) stage(k + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* cur = buf[k & 1];
        const int nloc = tpad - k * kChunk < kChunk ? tpad - k * kChunk : kChunk;
        // every lag up to kMaxOrder: no branch in the loop, so that the
        // loads run ahead (lags past order are never read)
        for (int j = tid; j < nloc; j += kThreads) {
            const float xn = cur[j];
#pragma unroll
            for (int i = 0; i <= kMaxOrder; ++i) acc[i] = fmaf(xn, cur[j + i], acc[i]);
        }
        __syncthreads();  // the chunk's buffer is free for chunk k + 2
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

    // 2. Levinson-Durbin (NB.c:120-148) on warp 0, every lane the same
    // steps: lpcs and r in registers, the steps unrolled so that every
    // index is known when compiling (only the step count is the order)
    if (warp == 0) {
        float L[kMaxOrder + 1], R[kMaxOrder + 1];
#pragma unroll
        for (int m = 0; m <= kMaxOrder; ++m) {
            R[m] = m <= order ? r[m] : 0.0f;
            L[m] = m == 0 ? 1.0f : 0.0f;
        }
        float alfa = __fmul_rn(R[0], 1.0f + 1.0e-9f);
#pragma unroll
        for (int m = 1; m <= kMaxOrder; ++m) {
            if (m > order) break;
            float s = 0.0f;
#pragma unroll
            for (int u = 1; u < m; ++u) s = __fadd_rn(s, __fmul_rn(L[u], R[m - u]));
            const float k = __fdiv_rn(-__fadd_rn(R[m], s), alfa);
            float tmp[kMaxOrder + 1];
#pragma unroll
            for (int u = 1; u < m; ++u) tmp[u] = __fadd_rn(L[u], __fmul_rn(k, L[m - u]));
#pragma unroll
            for (int u = 1; u < m; ++u) L[u] = tmp[u];
            L[m] = k;
            alfa = __fmul_rn(alfa, __fsub_rn(1.0f, __fmul_rn(k, k)));
        }
        float* out = lpcs_out + static_cast<long long>(c) * (order + 1);
#pragma unroll
        for (int m = 0; m <= kMaxOrder; ++m)
            if (m <= order && (m & 31) == lane) {
                lp[m] = L[m];
                out[m] = L[m];
            }
    }
    __syncthreads();

    // 3. the il-step recursions, forward on warp 0 and backward on warp
    // 1, lane u owning columns u (x0) and u+32 (x1).  Both keep a
    // column's basis as x[q], q = 0 the newest row, and predict with
    // co[q] = -lpcs[q+1]: the forward step sums q = order-1 .. 0 (basis
    // rows i .. i+order-1 of [eye; rows] against -(lpcs[order], ...,
    // lpcs[1])), the backward step q = 0 .. order-1 (rows i-1, ..., 0,
    // then eye rows 0, 1, ... against -(lpcs[1], ..., lpcs[order])); the
    // new row enters at q = 0.  coef_b_rev[i'] is backward step il-1-i'.
    if (warp < 2) {
        const bool fwd = warp == 0;
        float co[kMaxOrder], x0[kMaxOrder], x1[kMaxOrder];
#pragma unroll
        for (int q = 0; q < kMaxOrder; ++q) {
            co[q] = q < order ? -lp[q + 1] : 0.0f;
            const int e = fwd ? order - 1 - q : q;  // the eye row at q
            x0[q] = e == lane ? 1.0f : 0.0f;
            x1[q] = e == lane + 32 ? 1.0f : 0.0f;
        }
        float* dst = (fwd ? coef_f : coef_b_rev) + static_cast<long long>(c) * il * order;
        for (int i = 0; i < il; ++i) {
            float v0 = 0.0f, v1 = 0.0f;
            // the terms past order have co = 0 and a finite basis, and a
            // sum that starts at +0 never reaches -0, so they add +-0
            // exactly: the same result as stopping at order, without a
            // branch a term (the groups of 8 past order are skipped)
            if (fwd) {
#pragma unroll
                for (int g = kMaxOrder / 8 - 1; g >= 0; --g)
                    if (8 * g < order)
#pragma unroll
                        for (int q = 8 * g + 7; q >= 8 * g; --q) {
                            v0 = fmaf(co[q], x0[q], v0);
                            v1 = fmaf(co[q], x1[q], v1);
                        }
            } else {
#pragma unroll
                for (int g = 0; g < kMaxOrder / 8; ++g)
                    if (8 * g < order)
#pragma unroll
                        for (int q = 8 * g; q < 8 * g + 8; ++q) {
                            v0 = fmaf(co[q], x0[q], v0);
                            v1 = fmaf(co[q], x1[q], v1);
                        }
            }
#pragma unroll
            for (int q = kMaxOrder - 1; q > 0; --q) {
                x0[q] = x0[q - 1];
                x1[q] = x1[q - 1];
            }
            x0[0] = v0;
            x1[0] = v1;
            float* row = dst + (fwd ? i : il - 1 - i) * order;
            if (lane < order) row[lane] = v0;
            if (lane + 32 < order) row[lane + 32] = v1;
        }
    }
}

// ------------------------------------------------------------- nb_repair

// Shared memory of the repair launch, in 4-byte words: the compact
// original and current spans, the backward predictions (then slack for
// the chain's reads past a span's basis), the candidate masks and (where
// it fits) the residual.
struct RepairLayout {
    int span, orig, cur, bpatch, masks, res, total;
};

__host__ __device__ inline RepairLayout repair_layout(int t, int order, int il, bool with_res) {
    const int lo = order + (il - 1) / 2;
    RepairLayout l;
    l.span = 2 * order + il;
    l.orig = 0;
    l.cur = kSlots * l.span;
    l.bpatch = 2 * kSlots * l.span;
    l.masks = l.bpatch + kSlots * il + 2 * kMaxOrder;
    l.res = l.masks + (t > lo ? (t - lo + 31) / 32 : 0);
    l.total = l.res + (with_res ? t : 0);
    return l;
}

template <bool kProbe>
__global__ void __launch_bounds__(kThreads)
nb_repair_kernel(const float* __restrict__ wb, const float* __restrict__ temp,
                 const float* __restrict__ lpcs, const float* __restrict__ coef_f,
                 const float* __restrict__ coef_b_rev, float* __restrict__ wbf,
                 int* __restrict__ count_out, int* __restrict__ positions_out,
                 float* __restrict__ thr_out, int wlen, int t, int order, int il,
                 float thresh, int with_res) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float red[kWarps];
    __shared__ int pos_s[kSlots], off_s[kSlots];
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
    const RepairLayout lay = repair_layout(t, order, il, with_res != 0);
    const int span = lay.span;
    float* orig_c = smem + lay.orig;
    float* cur_c = smem + lay.cur;
    float* bpatch = smem + lay.bpatch;
    uint32_t* masks = reinterpret_cast<uint32_t*>(smem + lay.masks);
    float* res_s = with_res ? smem + lay.res : nullptr;

    if (kProbe) {
        // the densest chain the search can give: 20 slots PL + 1 apart
        if (tid < kSlots) pos_s[tid] = pl + tid * (pl + 1);
        if (tid == 0) count_s = kSlots;
    } else {
        // 1. threshold (nb.py:125-129); the residual read once
        float s = 0.0f;
        if (res_s) {
#pragma unroll 8
            for (int n = tid; n < t; n += kThreads) {
                const float v = res[n];
                res_s[n] = v;
                s += v;
            }
        } else {
#pragma unroll 8
            for (int n = tid; n < t; n += kThreads) s += res[n];
        }
        const float mean = __fdiv_rn(block_sum(s, red), static_cast<float>(t));
        const float* rs = res_s ? res_s : res;
        float s2 = 0.0f;
#pragma unroll 8
        for (int n = tid; n < t; n += kThreads) {
            const float d = __fsub_rn(rs[n], mean);
            s2 = fmaf(d, d, s2);
        }
        const float sigma2 = __fdiv_rn(block_sum(s2, red), static_cast<float>(t - 1));
        if (warp == 0) {
            const float* lp = lpcs + static_cast<long long>(c) * (order + 1);
            const float a0 = lane < order ? lp[lane] : 0.0f;
            const float a1 = lane + 32 < order ? lp[lane + 32] : 0.0f;
            const float q0 = __fmul_rn(a0, a0), q1 = __fmul_rn(a1, a1);
            float power = 0.0f;
            for (int k = 0; k < order; ++k)
                power = __fadd_rn(power, __shfl_sync(kAll, k < 32 ? q0 : q1, k & 31));
            if (lane == 0) thr_s = __fmul_rn(thresh, __fsqrt_rn(__fmul_rn(sigma2, power)));
        }
        __syncthreads();
        const float thr = thr_s;
        // 2. candidates as bit masks, 32 positions a word
        for (int w = warp; w < nwords; w += kWarps) {
            const int pos = lo + w * 32 + lane;
            const bool hit = pos < t && fabsf(rs[pos]) > thr;
            const uint32_t m = __ballot_sync(kAll, hit);
            if (lane == 0) masks[w] = m;
        }
        __syncthreads();
        // 3. greedy search, uniform across warp 0's lanes: 32 words at a
        // time, the words with a candidate walked in order
        if (warp == 0) {
            int cnt = 0, nxt = lo;
            for (int w0 = 0; w0 < nwords && cnt < kSlots; w0 += 32) {
                const uint32_t mine = w0 + lane < nwords ? masks[w0 + lane] : 0u;
                uint32_t busy = __ballot_sync(kAll, mine != 0u);
                while (busy != 0u && cnt < kSlots) {
                    const int l = __ffs(static_cast<int>(busy)) - 1;
                    busy &= busy - 1u;
                    uint32_t m = __shfl_sync(kAll, mine, l);
                    while (m != 0u && cnt < kSlots) {
                        const int p = lo + (w0 + l) * 32 + __ffs(static_cast<int>(m)) - 1;
                        m &= m - 1u;
                        if (p >= nxt) {
                            if (lane == 0) pos_s[cnt] = p - order;
                            ++cnt;
                            nxt = p + pl + 1;
                        }
                    }
                }
            }
            if (lane == 0) count_s = cnt;
        }
    }
    __syncthreads();
    // 4. each slot's span in the compact buffers: span j starts
    // min(p_j - p_{j-1}, span) after span j-1, so a sample that two
    // spans share has one place
    const int cnt = count_s;
    if (tid == 0) {
        int off = 0;
        for (int j = 0; j < cnt; ++j) {
            if (j > 0) {
                const int gap = pos_s[j] - pos_s[j - 1];
                off += gap < span ? gap : span;
            }
            off_s[j] = off;
        }
    }
    __syncthreads();
    for (int k = tid; k < cnt * span; k += kThreads) {
        const int j = k / span, e = k - j * span;
        const float v = orig[pos_s[j] + e];
        orig_c[off_s[j] + e] = v;
        cur_c[off_s[j] + e] = v;
    }
    __syncthreads();
    // 5. the backward predictions of every slot (original samples only)
    const float* cfc = coef_f + static_cast<long long>(c) * il * order;
    const float* cbc = coef_b_rev + static_cast<long long>(c) * il * order;
    for (int k = tid; k < cnt * il; k += kThreads) {
        const int j = k / il, i = k - j * il;
        const float* rb = cbc + i * order;
        const float* bb = orig_c + off_s[j] + order + il;
        float bp = 0.0f;
#pragma unroll 8
        for (int o = 0; o < order; ++o) bp = fmaf(rb[o], bb[o], bp);
        bpatch[k] = bp;
    }
    __syncthreads();
    // 6. the repairs, slot after slot (NB.c:205-245), on the first
    // ceil(il/32) warps
    const int nchain = (il + 31) / 32 * 32;
    if (tid < nchain) {
        float rf[kMaxOrder];
#pragma unroll
        for (int o = 0; o < kMaxOrder; ++o) rf[o] = tid < il && o < order ? cfc[tid * order + o] : 0.0f;
        const float wbw = tid < il ? __fdiv_rn(static_cast<float>(tid), static_cast<float>(il - 1))
                                   : 0.0f;
        const float wfw = tid < il ? __fdiv_rn(static_cast<float>(il - 1 - tid),
                                               static_cast<float>(il - 1))
                                   : 0.0f;
        for (int j = 0; j < cnt; ++j) {
            if (tid < il) {
                // the basis first (the spans are followed by 2 * kMaxOrder
                // words of slack), then the sum in groups of 8 terms: rf
                // is 0 and v 0 past order, and a sum from +0 never reaches
                // -0, so those terms add +0 exactly
                const float* ob = orig_c + off_s[j];
                const float* cb = cur_c + off_s[j];
                float v[kMaxOrder];
#pragma unroll
                for (int o = 0; o < kMaxOrder; ++o) {
                    const float v0 = ob[o];
                    v[o] = o < order ? __fadd_rn(v0, __fsub_rn(cb[o], v0)) : 0.0f;
                }
                const float bp = bpatch[j * il + tid];
                float fp = 0.0f;
#pragma unroll
                for (int g = 0; g < kMaxOrder / 8; ++g)
                    if (8 * g < order)
#pragma unroll
                        for (int o = 8 * g; o < 8 * g + 8; ++o) fp = fmaf(rf[o], v[o], fp);
                cur_c[off_s[j] + order + tid] = __fadd_rn(__fmul_rn(wfw, fp), __fmul_rn(wbw, bp));
            }
            if (nchain == 32)
                __syncwarp();
            else
                asm volatile("bar.sync 1, %0;\n" ::"r"(nchain) : "memory");
        }
    }
    __syncthreads();
    // 7. the repaired buffer in one pass: a sample of a span from the
    // current samples (the latest span that starts at or before it),
    // any other from wb; the probe writes its spans alone
    const int n_lo = kProbe ? (cnt > 0 ? pos_s[0] : 0) : 0;
    const int n_hi = kProbe ? (cnt > 0 ? pos_s[cnt - 1] + span : 0) : wlen;
    constexpr int kBatch = 8;  // loads of wb in flight a thread
    int j = -1;
    for (int n0 = n_lo + tid; n0 < n_hi; n0 += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int n = n0 + u * kThreads;
            v[u] = n < n_hi ? orig[n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int n = n0 + u * kThreads;
            if (n < n_hi) {
                while (j + 1 < cnt && pos_s[j + 1] <= n) ++j;
                out[n] = j >= 0 && n < pos_s[j] + span ? cur_c[off_s[j] + n - pos_s[j]] : v[u];
            }
        }
    }
    if (!kProbe) {
        if (tid < kSlots) positions_out[c * kSlots + tid] = tid < cnt ? pos_s[tid] : 0;
        if (tid == 0) {
            count_out[c] = cnt;
            thr_out[c] = thr_s;
        }
    }
}

// Opt in to all the shared memory a block may have, once per device
// and kernel; the most there is for the dynamic part, in bytes.
template <bool kProbe>
cudaError_t opt_in_shared(int device, int* most) {
    static int opted[kMaxDevices] = {};
    if (device < kMaxDevices && opted[device]) {
        *most = opted[device];
        return cudaSuccess;
    }
    int all = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(&all, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nb_repair_kernel<kProbe>);
    if (err == cudaSuccess) {
        *most = all - static_cast<int>(attr.sharedSizeBytes);
        err = cudaFuncSetAttribute(nb_repair_kernel<kProbe>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, *most);
    }
    if (err != cudaSuccess) {
        cudaGetLastError();  // not left for the next launcher to report
        return err;
    }
    if (device < kMaxDevices) opted[device] = *most;
    return cudaSuccess;
}

// The residual is staged when it fits beside the spans and masks; a
// step whose masks alone do not fit (t past ~1.3M samples at order 40,
// il 201) is refused.
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
    int most = 0;
    err = opt_in_shared<kProbe>(device, &most);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t word = sizeof(float);
    bool with_res = !kProbe;
    if (word * repair_layout(t, order, il, with_res).total > static_cast<size_t>(most))
        with_res = false;
    const size_t smem = word * repair_layout(t, order, il, with_res).total;
    if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
    nb_repair_kernel<kProbe><<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wb, temp, lpcs, coef_f, coef_b_rev, wbf, count, positions, thr, wlen, t, order, il,
        thresh, with_res ? 1 : 0);
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
    nb_lpc_kernel<<<channels, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// The repair chain alone over 20 slots PL + 1 apart (their spans
// staged, the backward predictions, the chain, the spans written back);
// wbf must hold wb.
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
