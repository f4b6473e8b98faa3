// K-ANR: block LMS noise reduction / auto-notch, one chain per channel.
//
// Replaces the lax.scan over _block_body in anr_process
// (phantomsdr_tpu/ops/anr.py), the block reformulation of wdsp's
// variable-leak LMS (jsdsp/lib/ANR.c).  Per channel the step's samples
// run in blocks of bsz (the last block len mod bsz); per block, with
// seg = the taps+delay-1 history samples (oldest first) ++ the block:
//   y_n     = sum_j w_j seg[taps-1-j+n]        (block-start weights)
//   sigma_n = sum_j seg[taps-1-j+n]^2, inv_n = 1 / (sigma_n + 1e-10)
//   e_n     = x_n - y_n, out_n = e_n (notch) or 4 y_n
//   nel_n   = |e_n (1 - two_mu sigma_n inv_n)|
//   nev_n   = |x_n - (1 - two_mu ngamma) y_n - two_mu e_n sigma_n inv_n|
//   lidx    = 120 if any nev_n < nel_n, ngamma = gamma lidx^4 6.25e-10
//   w_t     = lam^bsz w_t + sum_n (two_mu e_n inv_n) seg[taps-1-t+n],
//             lam = 1 - two_mu ngamma, lam^bsz by binary exponentiation
//             (JAX's integer_pow)
// and the carries come back in JAX's layout (hist newest first).
//
// Bound: operations, three taps-long products a sample (0.32 GFLOP at
// the bench shape, 128 channels x 6480 samples, taps 64).  The blocks of
// a channel are a dependent chain: a block's prediction needs the
// weights the one before it produced.
//
// Design: one block of 256 threads per channel.  Shared-memory traffic,
// not arithmetic, set the first design's pace (each thread loaded its
// whole window: 64 KB a block for the prediction, twice that for the
// update), so every taps-long sum here runs as one of K adjacent chains
// of a thread over a register window: the chains share all but one new
// value a step, and lanes K samples apart (K odd) read distinct banks.
// - The stream (history ++ x) is staged by cp.async in segments of
//   about 2048 samples (whole LMS blocks) into a ring in shared memory
//   that holds the history and two segments, mapped twice (each sample
//   stored at q and q + ring), so that the span a segment reads is one
//   contiguous run at an offset: no slide.
// - Warps 0-2 run the chain, synchronised by a named barrier of their
//   96 threads; warps 3 and 7 produce (both issue on the fourth SM
//   sub-partition, warp w on w mod 4, so the chain's warps keep theirs
//   to themselves): while the chain runs segment k's blocks they stage
//   segment k+1 (its ring places held segment k-1) and form its window
//   powers sigma_n and inv_n, which depend on the stream alone (9
//   adjacent samples a thread), into the other of two buffers.  One
//   block barrier a segment hands it over.
// - Per LMS block: each chain thread predicts 3 adjacent samples (their
//   values and the weights' float4s loaded a group of 8 taps ahead of
//   the FMAs), writes the outputs and c1_n = two_mu e_n inv_n (each
//   part of the update 16-byte aligned); the chain ORs the leak
//   triggers in its barrier; then 256/taps parts of contiguous samples,
//   3 adjacent taps a thread, form the update's partial sums (c1 as
//   float4 broadcasts), and taps threads add the parts in order and
//   update the weights (lam^bsz recomputed only when ngamma or the
//   block length changes).  Three chain barriers a block.
// Every sum keeps one order whatever the thread layout (fmaf over j from
// 0; each update part over its samples in order, the parts added in
// order), so the outputs are the same bit for bit as those of the
// earlier one-block-staged kernel.  anr_chain_probe
// stages the first segment and forms its powers once, then runs the
// whole chain of blocks over its data (the last of its blocks standing
// in for later ones), without output stores, as the floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChain = 96;          // threads of the chain: warps 0-2
constexpr int kProducers = 64;      // warps 3 and 7, both on the fourth SM sub-partition
constexpr int kParts = 256;         // the update's parts: kParts / taps (a fixed sum order)
constexpr int kGroup = 8;           // steps whose loads are issued ahead of their FMAs
constexpr int kRun = 3;             // adjacent chains a thread: predictions, update taps
constexpr int kPowRun = 9;          // adjacent window powers a thread
constexpr int kSegTarget = 2048;    // samples per staged segment (whole LMS blocks)
constexpr int kPad = 16;            // floats before the ring: prefetches reach 15 back
constexpr int kMaxDevices = 64;

struct Args {
    const float* x;
    const float* hist0;
    const float* w0;
    const float* lidx0;
    const float* ngamma0;
    float* out;
    float* hist1;
    float* w1;
    float* lidx1;
    float* ngamma1;
    int len, taps, delay, bsz, notch;
    float two_mu, gamma;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Samples per segment: whole blocks, about kSegTarget.
__host__ __device__ inline int segment_len(int bsz) {
    return bsz < kSegTarget ? (kSegTarget / bsz) * bsz : bsz;
}

// Shared memory, as offsets in floats: the ring (history + two
// segments, twice), sigma and inv of two segments, the weights (zero
// padded for the float4 prefetch), c1 (each part of the update at a
// 16-byte boundary) and the parts of the update.
struct Layout {
    int ring, seg, sig, inv, w, c1, part, total;
};

__host__ __device__ inline Layout layout(int taps, int delay, int bsz) {
    const int parts = taps < kParts ? kParts / taps : 1;
    Layout l;
    l.seg = segment_len(bsz);
    l.ring = taps + delay - 1 + 2 * l.seg;
    l.sig = kPad + round4(2 * l.ring);
    l.inv = l.sig + 2 * round4(l.seg);
    l.w = l.inv + 2 * round4(l.seg);
    l.c1 = l.w + round4((taps + kGroup - 1) / kGroup * kGroup + kGroup);
    l.part = l.c1 + parts * round4((bsz + parts - 1) / parts) + 2 * kGroup;
    l.total = l.part + round4(parts * taps);
    return l;
}

__device__ __forceinline__ float leak(float gamma, float lidx) {
    const float l2 = __fmul_rn(lidx, lidx);
    return __fmul_rn(__fmul_rn(__fmul_rn(gamma, l2), l2), 6.25e-10f);
}

// x^n for n >= 1, in the order of JAX's integer_pow lowering
__device__ __forceinline__ float int_pow(float x, int n) {
    float acc = 1.0f;
    bool have = false;
    while (n > 0) {
        if (n & 1) {
            acc = have ? __fmul_rn(acc, x) : x;
            have = true;
        }
        n >>= 1;
        if (n > 0) x = __fmul_rn(x, x);
    }
    return acc;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// K chains over a window that slides back: chain k sums w[j] b[k-j]
// (kSquare: b[k-j]^2) over j = 0..taps-1 in order from 0.  The window
// a[r] = b[K-1-J-r] of the group of steps from J holds K+7 values; each
// group loads the next group's 8 new values (and weights) before its
// FMAs.  w is 16-byte aligned and padded; b[-taps-7] is still shared
// memory.
template <int K, bool kSquare>
__device__ __forceinline__ void sliding_sums(const float* b, const float* __restrict__ w, int taps,
                                             float s[K]) {
    constexpr int A = K + kGroup - 1;
    float a[A];
#pragma unroll
    for (int r = 0; r < A; ++r) a[r] = b[K - 1 - r];
    float4 wa = make_float4(0.0f, 0.0f, 0.0f, 0.0f), wb = wa;
    if (!kSquare) {
        wa = ld4(w);
        wb = ld4(w + 4);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0.0f;
    int j = 0;
    for (; j + kGroup <= taps; j += kGroup) {
        float nw[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) nw[q] = b[-j - kGroup - q];
        float4 na = wa, nb = wb;
        if (!kSquare) {
            na = ld4(w + j + kGroup);
            nb = ld4(w + j + kGroup + 4);
        }
        const float wr[kGroup] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float v = a[K - 1 - k + q];
                s[k] = fmaf(kSquare ? v : wr[q], v, s[k]);
            }
#pragma unroll
        for (int r = 0; r < K - 1; ++r) a[r] = a[r + kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) a[K - 1 + q] = nw[q];
        wa = na;
        wb = nb;
    }
    if (j == taps) return;  // no partial group: skip its predicated FMAs
    const float wr[kGroup] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
        if (j + q < taps)
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float v = a[K - 1 - k + q];
                s[k] = fmaf(kSquare ? v : wr[q], v, s[k]);
            }
}

// K chains over a window that slides forward: chain k sums c[n] b[n-k]
// over n = 0..len-1 in order from 0.  The window a[r] = b[N-(K-1)+r] of
// the group from N holds K+7 values; c (16-byte aligned) comes as
// float4 broadcasts; each group loads the next group's before its
// FMAs.  b[len+7] and c[len+7] are still shared memory.
template <int K>
__device__ __forceinline__ void sliding_update(const float* __restrict__ c, const float* b, int len,
                                               float g[K]) {
    constexpr int A = K + kGroup - 1;
#pragma unroll
    for (int k = 0; k < K; ++k) g[k] = 0.0f;
    if (len <= 0) return;
    float a[A];
#pragma unroll
    for (int r = 0; r < A; ++r) a[r] = b[r - (K - 1)];
    float4 ca = ld4(c), cb = ld4(c + 4);
    int n = 0;
    for (; n + kGroup <= len; n += kGroup) {
        float nw[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) nw[q] = b[n + kGroup + q];
        const float4 na = ld4(c + n + kGroup), nb = ld4(c + n + kGroup + 4);
        const float cr[kGroup] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
#pragma unroll
            for (int k = 0; k < K; ++k) g[k] = fmaf(cr[q], a[q - k + K - 1], g[k]);
#pragma unroll
        for (int r = 0; r < K - 1; ++r) a[r] = a[r + kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) a[K - 1 + q] = nw[q];
        ca = na;
        cb = nb;
    }
    if (n == len) return;  // no partial group
    const float cr[kGroup] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
        if (n + q < len)
#pragma unroll
            for (int k = 0; k < K; ++k) g[k] = fmaf(cr[q], a[q - k + K - 1], g[k]);
}

__device__ __forceinline__ void chain_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kChain) : "memory");
}

// The chain's barrier with an OR of v over its threads.
__device__ __forceinline__ int chain_sync_or(int v) {
    int r;
    asm volatile(
        "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n"
        " bar.red.or.pred q, 1, %2, p;\n selp.s32 %0, 1, 0, q;\n}\n"
        : "=r"(r)
        : "r"(v), "n"(kChain)
        : "memory");
    return r;
}

__device__ __forceinline__ void producer_sync() {
    asm volatile("bar.sync 2, %0;\n" ::"n"(kProducers) : "memory");
}

// A producer's rank (warps 3 and 7: warp w issues on sub-partition w mod
// 4, so they take no issue slot from the chain's warps), else -1.
__device__ __forceinline__ int producer_rank(int tid) {
    const int warp = tid >> 5;
    return warp == 3 ? tid - 96 : (warp == 7 ? tid - 192 : -1);
}

template <bool kProbe>
__global__ void __launch_bounds__(kThreads) anr_kernel(Args a) {
    extern __shared__ __align__(16) float smem[];
    const int taps = a.taps;
    const int lkeep = taps + a.delay - 1;
    const int hl = taps + a.delay;
    const int parts = taps < kParts ? kParts / taps : 1;
    const Layout lay = layout(taps, a.delay, a.bsz);
    const int ring_len = lay.ring, seg_max = lay.seg, seg_pad = round4(lay.seg);
    float* ring = smem + kPad;
    float* w = smem + lay.w;
    float* c1 = smem + lay.c1;
    float* part = smem + lay.part;
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const long long row = static_cast<long long>(c) * a.len;
    const float* xrow = a.x + row;
    const int nsegs = (a.len + seg_max - 1) / seg_max;
    auto seg_at = [&](int k) { return ring + k * seg_max % ring_len; };
    auto seg_n = [&](int k) { return a.len - k * seg_max < seg_max ? a.len - k * seg_max : seg_max; };
    auto sig_of = [&](int k) { return smem + lay.sig + (k & 1) * seg_pad; };
    auto inv_of = [&](int k) { return smem + lay.inv + (k & 1) * seg_pad; };

    // the stream X(i), i >= -lkeep, sits at ring[q] and ring[q + ring_len],
    // q = (i + lkeep) mod ring_len; X(i < 0) is the history
    auto stage = [&](int i0, int n, int first, int step) {
        int q = (i0 + lkeep) % ring_len + first;
        for (int k = first; k < n; k += step, q += step) {
            if (q >= ring_len) q -= ring_len;
            cp_async4(ring + q, xrow + i0 + k);
            cp_async4(ring + q + ring_len, xrow + i0 + k);
        }
    };
    // the window powers of segment k, kPowRun adjacent samples a thread
    auto powers = [&](int k, int first, int step) {
        const float* seg = seg_at(k);
        const int nseg = seg_n(k);
        float* sg = sig_of(k);
        float* iv = inv_of(k);
        for (int n0 = first * kPowRun; n0 < nseg; n0 += step * kPowRun) {
            float s[kPowRun];
            sliding_sums<kPowRun, true>(seg + n0 + taps - 1, nullptr, taps, s);
#pragma unroll
            for (int j = 0; j < kPowRun; ++j)
                if (n0 + j < nseg) {
                    sg[n0 + j] = s[j];
                    iv[n0 + j] = __fdiv_rn(1.0f, __fadd_rn(s[j], 1e-10f));
                }
        }
    };

    for (int q = tid; q < lkeep; q += kThreads) {
        const float* h = a.hist0 + static_cast<long long>(c) * hl + lkeep - 1 - q;
        cp_async4(ring + q, h);
        cp_async4(ring + q + ring_len, h);
    }
    if (nsegs > 0) stage(0, seg_n(0), tid, kThreads);
    cp_async_commit();
    const int wlen = lay.c1 - lay.w;
    for (int j = tid; j < wlen; j += kThreads) w[j] = j < taps ? a.w0[c * taps + j] : 0.0f;
    if (tid < kPad) smem[tid] = 0.0f;
    cp_async_wait<0>();
    __syncthreads();
    if (nsegs > 0) powers(0, tid, kThreads);
    __syncthreads();

    float lidx = a.lidx0[c];
    float ngamma = a.ngamma0[c];
    const float two_mu = a.two_mu;
    float lam_b = 1.0f, lam_of = 0.0f;  // lam^nb for lam_of, nb = lam_n
    int lam_n = 0;
    const int per = (taps + kRun - 1) / kRun;  // the update's threads a part

    // one LMS block on the chain's threads: samples boff .. boff+nb-1 of
    // segment k (seg[m] = X(S - lkeep + m)); outputs from out_at (probe:
    // none)
    auto block = [&](int k, int boff, int nb, long long out_at) {
        const float* seg = seg_at(k);
        const float* sig = sig_of(k);
        const float* inv = inv_of(k);
        // 1. predictions, outputs, update factors, leak triggers; c1 of
        // part p of the update at c1 + p * cstride
        const float keep_y = __fsub_rn(1.0f, __fmul_rn(two_mu, ngamma));
        const int chunk = (nb + parts - 1) / parts;
        const int cstride = round4(chunk);
        // n0 / chunk without a division: (n0 + 0.5) / chunk is below
        // 256 and (n0 + 0.5) * rchunk within 2^-15 of it, inside its
        // 0.5 / chunk margin from an integer (chunk <= 4096)
        const float rchunk = __frcp_rn(static_cast<float>(chunk));
        int trig = 0;
        for (int n0 = tid * kRun; n0 < nb; n0 += kChain * kRun) {
            float y[kRun];
            sliding_sums<kRun, false>(seg + boff + taps - 1 + n0, w, taps, y);
            int p = __float2int_rz(__fmul_rn(static_cast<float>(n0) + 0.5f, rchunk));
            // all kRun samples without a branch between them (a sample
            // past nb reads shared memory in range and stores nothing)
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                const int n = n0 + j;
                const bool in = n < nb;
                const float xn = seg[lkeep + boff + n];
                const float sigma = sig[boff + n], iv = inv[boff + n];
                const float err = __fsub_rn(xn, y[j]);
                if (!kProbe && in) a.out[out_at + n] = a.notch ? err : __fmul_rn(4.0f, y[j]);
                const float ts = __fmul_rn(__fmul_rn(two_mu, sigma), iv);
                const float nel = fabsf(__fmul_rn(err, __fsub_rn(1.0f, ts)));
                const float nev = fabsf(__fsub_rn(
                    __fsub_rn(xn, __fmul_rn(keep_y, y[j])),
                    __fmul_rn(__fmul_rn(__fmul_rn(two_mu, err), sigma), iv)));
                trig |= in && nev < nel;
                if (n >= (p + 1) * chunk) ++p;
                if (in) c1[p * cstride + n - p * chunk] = __fmul_rn(__fmul_rn(two_mu, err), iv);
            }
        }
        if (chain_sync_or(trig)) lidx = 120.0f;
        ngamma = leak(a.gamma, lidx);
        const float lam = __fsub_rn(1.0f, __fmul_rn(two_mu, ngamma));
        if (lam_n != nb || !(lam == lam_of)) {
            lam_b = int_pow(lam, nb);
            lam_of = lam;
            lam_n = nb;
        }
        // 2. the update, in parts of contiguous samples, kRun adjacent
        // taps a thread
        for (int k2 = tid; k2 < parts * per; k2 += kChain) {
            const int p = k2 / per, t0 = (k2 - p * per) * kRun;
            const int n0 = p * chunk;
            const int n1 = n0 + chunk < nb ? n0 + chunk : nb;
            float g[kRun];
            sliding_update<kRun>(c1 + p * cstride, seg + boff + taps - 1 - t0 + n0, n1 - n0, g);
#pragma unroll
            for (int j = 0; j < kRun; ++j)
                if (t0 + j < taps) part[p * taps + t0 + j] = g[j];
        }
        chain_sync();
        for (int t = tid; t < taps; t += kChain) {
            float g = part[t];
#pragma unroll 4
            for (int p = 1; p < parts; ++p) g = __fadd_rn(g, part[p * taps + t]);
            w[t] = __fadd_rn(__fmul_rn(lam_b, w[t]), g);
        }
        chain_sync();
    };

    // segment k: the chain runs its blocks while the producers stage
    // segment k+1 and form its window powers
    const int rank = producer_rank(tid);
    for (int k = 0; k < nsegs; ++k) {
        if (rank >= 0) {
            if (!kProbe && k + 1 < nsegs) {
                stage((k + 1) * seg_max, seg_n(k + 1), rank, kProducers);
                cp_async_commit();
                cp_async_wait<0>();
                producer_sync();
                powers(k + 1, rank, kProducers);
            }
        } else if (tid >= kChain) {
            // warps 4-6 wait for the hand-over
        } else if (kProbe) {
            // the chain of the whole stream over segment 0's blocks
            const int last = (seg_n(0) - 1) / a.bsz * a.bsz;
            for (int s = 0; s < a.len; s += a.bsz)
                block(0, s < last ? s : last, a.len - s < a.bsz ? a.len - s : a.bsz, 0);
        } else {
            const int nseg = seg_n(k);
            for (int b = 0; b < nseg; b += a.bsz)
                block(k, b, nseg - b < a.bsz ? nseg - b : a.bsz, row + k * seg_max + b);
        }
        __syncthreads();
        if (kProbe) break;
    }
    // carries: the newest taps+delay samples, newest first (the probe's:
    // those of its segment); the chain's values of w, lidx and ngamma
    const int kl = kProbe || nsegs == 0 ? 0 : nsegs - 1;
    const float* seg = seg_at(kl);
    const int nl = nsegs > 0 ? seg_n(kl) : 0;
    for (int k = tid; k < hl; k += kThreads) {
        if (a.len > 0)
            a.hist1[c * hl + k] = seg[lkeep + nl - 1 - k];
        else
            a.hist1[c * hl + k] = a.hist0[c * hl + k];
    }
    for (int t = tid; t < taps; t += kThreads) a.w1[c * taps + t] = w[t];
    if (tid == 0) {
        a.lidx1[c] = lidx;
        a.ngamma1[c] = ngamma;
    }
}

// Opt in to all the shared memory a block may have, once per device
// and kernel; the most there is, in bytes.
template <bool kProbe>
cudaError_t opt_in_shared(int device, int* most) {
    static int opted[kMaxDevices] = {};
    if (device < kMaxDevices && opted[device]) {
        *most = opted[device];
        return cudaSuccess;
    }
    cudaError_t err = cudaDeviceGetAttribute(most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(anr_kernel<kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   *most);
    if (err != cudaSuccess) {
        cudaGetLastError();  // not left for the next launcher to report
        return err;
    }
    if (device < kMaxDevices) opted[device] = *most;
    return cudaSuccess;
}

// A delay line and block too large for shared memory (past 227 KB on
// the H100: about 10,000 taps at blocks of 256) are refused.
template <bool kProbe>
int launch(const Args& a, int channels, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    if (a.taps < 1 || a.delay < 1 || a.bsz < 1) return static_cast<int>(cudaErrorInvalidValue);
    int most = 0;
    err = opt_in_shared<kProbe>(device, &most);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = sizeof(float) * static_cast<size_t>(layout(a.taps, a.delay, a.bsz).total);
    if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
    anr_kernel<kProbe><<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* x, const float* hist0, const float* w0, const float* lidx0,
               const float* ngamma0, float* out, float* hist1, float* w1, float* lidx1,
               float* ngamma1, int len, int taps, int delay, int bsz, int notch, float two_mu,
               float gamma) {
    return Args{x,   hist0, w0,    lidx0, ngamma0, out,   hist1,  w1,   lidx1,
                ngamma1, len, taps, delay, bsz, notch, two_mu, gamma};
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: [channels, len] float32; hist0/hist1: [channels, taps+delay];
// w0/w1: [channels, taps]; lidx/ngamma: [channels].
extern "C" int anr_launch(const float* x, const float* hist0, const float* w0,
                          const float* lidx0, const float* ngamma0, float* out, float* hist1,
                          float* w1, float* lidx1, float* ngamma1, int channels, int len,
                          int taps, int delay, int bsz, int notch, float two_mu, float gamma,
                          int device, void* stream) {
    return launch<false>(make_args(x, hist0, w0, lidx0, ngamma0, out, hist1, w1, lidx1, ngamma1,
                                   len, taps, delay, bsz, notch, two_mu, gamma),
                         channels, device, stream);
}

extern "C" int anr_chain_probe_launch(const float* x, const float* hist0, const float* w0,
                                      const float* lidx0, const float* ngamma0, float* out,
                                      float* hist1, float* w1, float* lidx1, float* ngamma1,
                                      int channels, int len, int taps, int delay, int bsz,
                                      int notch, float two_mu, float gamma, int device,
                                      void* stream) {
    return launch<true>(make_args(x, hist0, w0, lidx0, ngamma0, out, hist1, w1, lidx1, ngamma1,
                                  len, taps, delay, bsz, notch, two_mu, gamma),
                        channels, device, stream);
}
