// Negacyclic NTT / iNTT over RNS limbs for Hopper (sm_90a).
//
// Replaces the Pallas kernels of fhe_spear_tpu/core/ntt_pallas.py:
//   ntt_fwd_kernel<LOGN> <- _fwd_call (pallas_call at ntt_pallas.py:144), K1
//   ntt_inv_kernel<LOGN> <- _inv_call (pallas_call at ntt_pallas.py:199), K2
// Outputs equal NttContext.ntt_plain / intt_plain bit for bit: the same
// twiddles, the same bit-reversed evaluation order.
//
// What is computed.  The reference's Stockham loop (core/ntt.py:305-311)
// is an in-place DIF butterfly network: the stage on index bit h (h = N-1
// ... 0 forward, 0 ... N-1 inverse) pairs i0 (bit h clear) with i0 + 2^h
// and uses twiddle tw_h[i0 mod 2^h].  Forward: twist x_j by psi^j, then
// (a, b) -> (a + b, (a - b) * w).  Inverse: (u, v) -> (u + v*w, u - v*w),
// then untwist by psi^-j * N^-1.  The TPU kernel's lane rolls and iota masks
// (ntt_pallas.py:127-139, 172-185) exist only because Mosaic cannot reshape
// below 128 lanes; none of that is carried over.
//
// Design.
// * Register-resident passes.  A thread holds E = 32 words (N >= 32) and
//   runs the stages of up to 5 index bits on them without leaving its
//   registers.  The bits split into at most three passes (make_pass):
//   A = the top bits (4 at N >= 1024) plus, as spare register bits, the
//   lowest ones; B = bits 5..9 (its stages are the bits between A and C);
//   C = bits 0..4.  N = 8192 runs 4 + 4 + 5 stages with two exchanges
//   through shared memory, N = 16384 4 + 5 + 5.  A thread's element r of a
//   pass sits at index base(thread) | off(r), where off(r) deposits r's bits
//   on the pass's register bits and base the thread id's bits on the others
//   (ascending), so that a warp's 32 lanes always vary 5 consecutive index
//   bits within bits 0..9.  Shared memory is padded one word in 32 (word i
//   at i + i/32): those lane sets fall on 32 distinct banks, so no exchange
//   has bank conflicts, and pad(base | off) = pad(base) + pad(off) leaves
//   one run-time add a pass (the rest folds into the access's offset).
// * Pass A holds index bit 0 in register bit 0, so the int64 words move as
//   16-byte pairs, 512 contiguous bytes a warp: the forward reads x and the
//   inverse writes y straight from A's registers; the forward's output and
//   the inverse's input go through shared memory once more, in A's layout.
// * Shoup products.  Every constant multiplier c (twist, untwist, twiddle)
//   comes with c' = floor(c * 2^32 / p): a*c mod p = a*c - umulhi(a, c')*p,
//   in [0, 2p) for any a < 2^32, then one conditional subtraction: 5 integer
//   instructions against 9 for a Montgomery product.  The result is the
//   canonical a*c mod p, the word the plain version's mont_mul gives with
//   the Montgomery table c*R.  The tables ([L, N] pairs (c, c')) are built
//   once per context in core/ntt_cuda.py.
// * Twiddles: one table of N - 1 pairs a limb (stage on bit h at offset
//   N - 2^(h+1)); a butterfly's index is (base & (2^h - 1)) + a constant, so
//   the loads of a pass do not depend on the data and can be issued ahead
//   of the arithmetic.  With the limb-grouped grid they hit in L1 after a
//   CTA's first polynomial; staging the table in shared memory instead gained
//   at most 0.4 us a launch and lost at [184, 3] (measured: PERF.md).
// * A persistent, limb-grouped grid.  CTA (r, g) of R x G transforms
//   polynomials b = g, g + G, ... of limb row r, G chosen so that the grid
//   fills the card once with CTAs of equal work (make_plan): the limb's
//   tables stay in the SM's L1 across its polynomials, and no wave has a
//   tail.  Below N = 8192 a CTA of 256 threads holds several polynomials at
//   once (slots); N = 16384 takes 512 threads and 67.5 KB of dynamic shared
//   memory.  The forward runs 2 CTAs per SM (at most 128 registers a
//   thread); the inverse, whose launches on the main path are all small
//   (at most 90 polynomials), runs with no register cap, 1 CTA per SM,
//   which is faster there (measured: PERF.md).
// * The Montgomery conversion folded in: the wrapper passes a twist table of
//   psi^j * R (output to_mont(ntt(x))) or an untwist table of psi^-j N^-1
//   R^-1 (output from_mont(intt(y))); NTT and iNTT are linear over Z_p, so
//   those words equal the composed calls'.
//
// Bound on this card.  Each polynomial is read once and written once (8
// bytes a word); the arithmetic is (N/2) log2 N butterflies of 9 (forward)
// or 11 (inverse) integer instructions, below the bytes at the H100's rates,
// so the kernel is bounded by device-memory bytes.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLogN = 14;              // N = 16384
constexpr int kLogE = 5;                  // 32 words a thread
constexpr int kMinThreads = 256;
constexpr int kMaxSmemBytes = 232448;     // 227 KB, the per-block limit

// One pass of the schedule: the index bits its stages run on (lo..hi), the
// index bit of each register bit (reg) and of each thread-id bit (thr,
// ascending; the lowest 5 are the lanes of a warp).
struct Pass {
    int lo, hi, e, t;
    int reg[kLogE];
    int thr[kMaxLogN];
};

__host__ __device__ constexpr int num_passes(int logn) {
    return logn <= kLogE ? 1 : (logn <= 2 * kLogE - 1 ? 2 : 3);
}

__host__ __device__ constexpr Pass make_pass(int logn, int j) {
    Pass ps{};
    const int e = logn < kLogE ? logn : kLogE;
    const int np = num_passes(logn);
    unsigned mask = 0;
    if (j == 0) {                          // A: top bits + the lowest as spare
        const int k = np == 1 ? logn : (np == 2 ? logn - kLogE : 4);
        ps.lo = logn - k;
        ps.hi = logn - 1;
        mask = (((1u << k) - 1) << ps.lo) | ((1u << (e - k)) - 1);
    } else if (j == np - 1) {              // C: bits 0..4
        ps.lo = 0;
        ps.hi = kLogE - 1;
        mask = (1u << kLogE) - 1;
    } else {                               // B: bits 5..9, stages 5..N-5
        ps.lo = kLogE;
        ps.hi = logn - kLogE;
        mask = ((1u << kLogE) - 1) << kLogE;
    }
    ps.e = e;
    ps.t = logn - e;
    int nr = 0, nt = 0;
    for (int b = 0; b < logn; ++b) {
        if ((mask >> b) & 1u) ps.reg[nr++] = b;
        else ps.thr[nt++] = b;
    }
    return ps;
}

// index offset of register r / register bit of index bit h in pass j
__host__ __device__ constexpr int reg_off(int logn, int j, int r) {
    const Pass ps = make_pass(logn, j);
    int off = 0;
    for (int k = 0; k < ps.e; ++k)
        if ((r >> k) & 1) off |= 1 << ps.reg[k];
    return off;
}

__host__ __device__ constexpr int reg_pos(int logn, int j, int h) {
    const Pass ps = make_pass(logn, j);
    for (int k = 0; k < ps.e; ++k)
        if (ps.reg[k] == h) return k;
    return -1;
}

__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int threads_for(int logn) {
    const int t = logn < kLogE ? 1 : 1 << (logn - kLogE);
    return t > kMinThreads ? t : kMinThreads;
}

template <int LOGN>
struct Geo {
    static constexpr int N = 1 << LOGN;
    static constexpr int E = 1 << (LOGN < kLogE ? LOGN : kLogE);
    static constexpr int T_LOG = LOGN < kLogE ? 0 : LOGN - kLogE;
    static constexpr int T = 1 << T_LOG;          // threads a polynomial
    static constexpr int THREADS = threads_for(LOGN);
    static constexpr int SLOTS = THREADS / T;     // polynomials at once
    static constexpr int STRIDE = pad(N);         // shared words a slot
    static constexpr int PASSES = num_passes(LOGN);
    static_assert(reg_off(LOGN, 0, 1) == 1, "pass A holds index bit 0");
};

struct Params {
    const int64_t* x;
    int64_t* y;
    const int32_t* rows;
    long long B;
    int R, G, iters;           // limb rows; CTAs per row; polynomials a slot
    const uint2* twist;        // [L, N] (c, c'): twist (fwd) / untwist (inv)
    const uint2* tw;           // [L, N] twiddle pairs, stage h at N - 2^(h+1)
    const uint32_t* p;         // [L]
};

__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint2 w,
                                              uint32_t p) {
    // a * w.x mod p for a < 2^32, w.y = floor(w.x * 2^32 / p)
    const uint32_t q = __umulhi(a, w.y);
    const uint32_t r = a * w.x - q * p;           // in [0, 2p)
    return min(r, r - p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    const uint32_t s = a + b;                     // < 2p < 2^32
    return min(s, s - p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    const uint32_t d = a - b + p;                 // in [1, 2p)
    return min(d, d - p);
}

// f(std::integral_constant<int, i>) for i = 0 .. N-1, unrolled at compile
// time, so that every register index and offset below is a constant.
template <typename F, int... I>
__device__ __forceinline__ void static_for_seq(
    F&& f, std::integer_sequence<int, I...>) {
    (f(std::integral_constant<int, I>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    static_for_seq(f, std::make_integer_sequence<int, N>{});
}

template <int LOGN, int J>
__device__ __forceinline__ int thread_base(int u) {
    int base = 0;
    static_for<make_pass(LOGN, J).t>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        constexpr int bit = make_pass(LOGN, J).thr[k];
        base |= ((u >> k) & 1) << bit;
    });
    return base;
}

// The stages of pass J on the thread's registers (forward: top bit first).
// A butterfly's twiddle index is (base & (2^h - 1)) + a constant.
template <int LOGN, int J, bool FWD>
__device__ __forceinline__ void run_stages(uint32_t (&v)[Geo<LOGN>::E],
                                           const uint2* tw, int base,
                                           uint32_t p) {
    constexpr int lo = make_pass(LOGN, J).lo, hi = make_pass(LOGN, J).hi;
    static_for<hi - lo + 1>([&](auto sc) {
        constexpr int s = decltype(sc)::value;
        constexpr int h = FWD ? hi - s : lo + s;
        constexpr int rho = reg_pos(LOGN, J, h);
        static_assert(rho >= 0, "a pass's stage bits are register bits");
        const uint2* twh =
            tw + (Geo<LOGN>::N - (2 << h)) + (base & ((1 << h) - 1));
        static_for<Geo<LOGN>::E>([&](auto rc) {
            constexpr int r = decltype(rc)::value;
            if constexpr (((r >> rho) & 1) == 0) {
                constexpr int r2 = r | (1 << rho);
                constexpr int off = reg_off(LOGN, J, r) & ((1 << h) - 1);
                const uint2 w = __ldg(twh + off);
                const uint32_t a = v[r], b = v[r2];
                if constexpr (FWD) {
                    v[r] = add_mod(a, b, p);
                    v[r2] = mul_shoup(a - b + p, w, p);   // a - b + p < 2p
                } else {
                    const uint32_t t = mul_shoup(b, w, p);
                    v[r] = add_mod(a, t, p);
                    v[r2] = sub_mod(a, t, p);
                }
            }
        });
    });
}

template <int LOGN, int J>
__device__ __forceinline__ void smem_load(uint32_t (&v)[Geo<LOGN>::E],
                                          const uint32_t* sl, int base) {
    const uint32_t* s = sl + pad(base);
    static_for<Geo<LOGN>::E>([&](auto rc) {
        constexpr int r = decltype(rc)::value;
        constexpr int o = pad(reg_off(LOGN, J, r));
        v[r] = s[o];
    });
}

template <int LOGN, int J>
__device__ __forceinline__ void smem_store(const uint32_t (&v)[Geo<LOGN>::E],
                                           uint32_t* sl, int base) {
    uint32_t* s = sl + pad(base);
    static_for<Geo<LOGN>::E>([&](auto rc) {
        constexpr int r = decltype(rc)::value;
        constexpr int o = pad(reg_off(LOGN, J, r));
        s[o] = v[r];
    });
}

// A shared-memory pass: read pass J's words, run its stages, write them
// back where they came from (a thread's words are its own), barrier.
template <int LOGN, int J, bool FWD>
__device__ __forceinline__ void smem_pass(uint32_t* sl, const uint2* tw,
                                          uint32_t p, int u, bool active) {
    if (active) {
        uint32_t v[Geo<LOGN>::E];
        const int base = thread_base<LOGN, J>(u);
        smem_load<LOGN, J>(v, sl, base);
        run_stages<LOGN, J, FWD>(v, tw, base, p);
        smem_store<LOGN, J>(v, sl, base);
    }
    __syncthreads();
}

// Pass A's words of a polynomial as 16-byte pairs (index bit 0 is register
// bit 0), times the twist pairs when given.
template <int LOGN>
__device__ __forceinline__ void load_pairs(uint32_t (&v)[Geo<LOGN>::E],
                                           const int64_t* xp, int base,
                                           const uint2* twist, uint32_t p) {
    static_for<Geo<LOGN>::E / 2>([&](auto q) {
        constexpr int r = 2 * decltype(q)::value;
        const int i = base + reg_off(LOGN, 0, r);
        const longlong2 x2 =
            __ldg(reinterpret_cast<const longlong2*>(xp + i));
        v[r] = (uint32_t)x2.x;
        v[r + 1] = (uint32_t)x2.y;
        if (twist != nullptr) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(twist + i));
            v[r] = mul_shoup(v[r], make_uint2(w.x, w.y), p);
            v[r + 1] = mul_shoup(v[r + 1], make_uint2(w.z, w.w), p);
        }
    });
}

template <int LOGN>
__device__ __forceinline__ void store_pairs(uint32_t (&v)[Geo<LOGN>::E],
                                            int64_t* yp, int base,
                                            const uint2* twist, uint32_t p) {
    static_for<Geo<LOGN>::E / 2>([&](auto q) {
        constexpr int r = 2 * decltype(q)::value;
        const int i = base + reg_off(LOGN, 0, r);
        if (twist != nullptr) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(twist + i));
            v[r] = mul_shoup(v[r], make_uint2(w.x, w.y), p);
            v[r + 1] = mul_shoup(v[r + 1], make_uint2(w.z, w.w), p);
        }
        *reinterpret_cast<longlong2*>(yp + i) =
            make_longlong2((long long)v[r], (long long)v[r + 1]);
    });
}

template <int LOGN>
__global__ void __launch_bounds__(Geo<LOGN>::THREADS,
                                  Geo<LOGN>::THREADS > 256 ? 1 : 2)
ntt_fwd_kernel(const Params a) {
    using G = Geo<LOGN>;
    extern __shared__ uint32_t smem[];
    const int r = blockIdx.x / a.G, g = blockIdx.x % a.G;
    const int limb = a.rows[r];
    const uint32_t p = a.p[limb];
    const uint2* twist = a.twist + (size_t)limb * G::N;
    const uint2* tw = a.tw + (size_t)limb * G::N;
    const int slot = threadIdx.x >> G::T_LOG, u = threadIdx.x & (G::T - 1);
    uint32_t* sl = smem + slot * G::STRIDE;
    const int base0 = thread_base<LOGN, 0>(u);
    for (int it = 0; it < a.iters; ++it) {
        const long long b = g + (long long)(it * G::SLOTS + slot) * a.G;
        const bool active = b < a.B;
        const long long off = (b * a.R + r) * G::N;
        uint32_t v[G::E];
        if (active) {
            load_pairs<LOGN>(v, a.x + off, base0, twist, p);
            run_stages<LOGN, 0, true>(v, tw, base0, p);
        }
        if constexpr (G::PASSES == 1) {
            if (active) store_pairs<LOGN>(v, a.y + off, base0, nullptr, p);
        } else {
            __syncthreads();            // the previous polynomial's reads
            if (active) smem_store<LOGN, 0>(v, sl, base0);
            __syncthreads();
            smem_pass<LOGN, 1, true>(sl, tw, p, u, active);
            if constexpr (G::PASSES == 3)
                smem_pass<LOGN, 2, true>(sl, tw, p, u, active);
            if (active) {
                smem_load<LOGN, 0>(v, sl, base0);
                store_pairs<LOGN>(v, a.y + off, base0, nullptr, p);
            }
        }
    }
}

template <int LOGN>
__global__ void __launch_bounds__(Geo<LOGN>::THREADS, 1)
ntt_inv_kernel(const Params a) {
    using G = Geo<LOGN>;
    extern __shared__ uint32_t smem[];
    const int r = blockIdx.x / a.G, g = blockIdx.x % a.G;
    const int limb = a.rows[r];
    const uint32_t p = a.p[limb];
    const uint2* untwist = a.twist + (size_t)limb * G::N;
    const uint2* tw = a.tw + (size_t)limb * G::N;
    const int slot = threadIdx.x >> G::T_LOG, u = threadIdx.x & (G::T - 1);
    uint32_t* sl = smem + slot * G::STRIDE;
    const int base0 = thread_base<LOGN, 0>(u);
    for (int it = 0; it < a.iters; ++it) {
        const long long b = g + (long long)(it * G::SLOTS + slot) * a.G;
        const bool active = b < a.B;
        const long long off = (b * a.R + r) * G::N;
        uint32_t v[G::E];
        if constexpr (G::PASSES > 1) {
            if (active) load_pairs<LOGN>(v, a.x + off, base0, nullptr, p);
            __syncthreads();            // the previous polynomial's reads
            if (active) smem_store<LOGN, 0>(v, sl, base0);
            __syncthreads();
            if constexpr (G::PASSES == 3)
                smem_pass<LOGN, 2, false>(sl, tw, p, u, active);
            smem_pass<LOGN, 1, false>(sl, tw, p, u, active);
            if (active) smem_load<LOGN, 0>(v, sl, base0);
        } else {
            if (active) load_pairs<LOGN>(v, a.x + off, base0, nullptr, p);
        }
        if (active) {
            run_stages<LOGN, 0, false>(v, tw, base0, p);
            store_pairs<LOGN>(v, a.y + off, base0, untwist, p);
        }
    }
}

using KernelFn = void (*)(Params);

// One library per N: the build names its log2 N (core/ntt_cuda.py builds
// each size it transforms), so that a run compiles two kernels, not 28.
#ifndef FHE_NTT_LOGN
#error "build with -DFHE_NTT_LOGN=<log2 N>, 1 <= log2 N <= 14"
#endif
static_assert(FHE_NTT_LOGN >= 1 && FHE_NTT_LOGN <= kMaxLogN, "log2 N");

KernelFn kernel_for(bool forward, int logn) {
    if (logn != FHE_NTT_LOGN) return nullptr;
    return forward ? ntt_fwd_kernel<FHE_NTT_LOGN>
                   : ntt_inv_kernel<FHE_NTT_LOGN>;
}

struct Plan {
    int threads, smem, grid, per_cta, ctas_per_sm, G, iters;
};

// Threads, shared memory, grid and polynomials per CTA of one launch;
// raises the kernel's dynamic shared-memory limit when it needs more.
int make_plan(bool forward, int logn, int R, long long B, Plan* pl) {
    if (logn < 1 || logn > kMaxLogN || R < 1 || B < 1 ||
        B * R > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int n = 1 << logn;
    const int per_poly = logn < kLogE ? 1 : 1 << (logn - kLogE);
    pl->threads = threads_for(logn);
    const int slots = pl->threads / per_poly;
    pl->smem = num_passes(logn) == 1 ? 0 : slots * pad(n) * 4;
    if (pl->smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    KernelFn kern = kernel_for(forward, logn);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    // the dynamic shared-memory limit each kernel was last raised to
    static int limit[2] = {};
    int& lim = limit[forward ? 0 : 1];
    cudaError_t rc;
    if (pl->smem > 48 * 1024 && pl->smem > lim) {
        rc = cudaFuncSetAttribute((const void*)kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  pl->smem);
        if (rc != cudaSuccess) return (int)rc;
        lim = pl->smem;
    }
    int dev = 0, sms = 0;
    if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return (int)rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &pl->ctas_per_sm, (const void*)kern, pl->threads, pl->smem);
    if (rc != cudaSuccess) return (int)rc;
    if (pl->ctas_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // CTAs per row: fill the card once, then even out the polynomials
    const long long units = (B + slots - 1) / slots;   // slot-iterations
    long long G = (long long)pl->ctas_per_sm * sms / R;
    G = G < 1 ? 1 : (G > units ? units : G);
    const long long iters = (B + G * slots - 1) / (G * slots);
    G = (B + iters * slots - 1) / (iters * slots);
    if (G * R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    pl->G = (int)G;
    pl->iters = (int)iters;
    pl->grid = (int)(G * R);
    pl->per_cta = (int)(iters * slots);
    return 0;
}

int launch(bool forward, const void* x, void* y, const void* rows, int R,
           long long B, int logn, const void* twist, const void* tw,
           const void* p, void* stream) {
    Plan pl;
    const int rc = make_plan(forward, logn, R, B, &pl);
    if (rc != 0) return rc;
    Params a;
    a.x = (const int64_t*)x;
    a.y = (int64_t*)y;
    a.rows = (const int32_t*)rows;
    a.B = B;
    a.R = R;
    a.G = pl.G;
    a.iters = pl.iters;
    a.twist = (const uint2*)twist;
    a.tw = (const uint2*)tw;
    a.p = (const uint32_t*)p;
    KernelFn kern = kernel_for(forward, logn);
    kern<<<dim3((unsigned)pl.grid), pl.threads, pl.smem,
           (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward transform of x [B, R, N] into y: twist [L, N] pairs (psi^j, or
// psi^j * R for the Montgomery form), tw [L, N] forward twiddle pairs,
// p [L].  Returns cudaGetLastError() (or the error of planning the launch).
int fhe_ntt_fwd(const void* x, void* y, const void* rows, int R, long long B,
                int logn, const void* twist, const void* tw, const void* p,
                void* stream) {
    return launch(true, x, y, rows, R, B, logn, twist, tw, p, stream);
}

// Inverse transform of x [B, R, N] into y: untwist [L, N] pairs
// (psi^-j N^-1, or times R^-1 for the plain form), tw inverse twiddles.
int fhe_ntt_inv(const void* x, void* y, const void* rows, int R, long long B,
                int logn, const void* untwist, const void* tw, const void* p,
                void* stream) {
    return launch(false, x, y, rows, R, B, logn, untwist, tw, p, stream);
}

// The launch plan of a transform: out = {threads per CTA, shared bytes per
// CTA, CTAs, polynomials per CTA (at most), CTAs per SM}.
int fhe_ntt_plan(int forward, int logn, int R, long long B, int* out) {
    Plan pl;
    const int rc = make_plan(forward != 0, logn, R, B, &pl);
    if (rc != 0) return rc;
    out[0] = pl.threads;
    out[1] = pl.smem;
    out[2] = pl.grid;
    out[3] = pl.per_cta;
    out[4] = pl.ctas_per_sm;
    return 0;
}

// Pass j of the schedule at log2 N = logn: out = {lo, hi, e, t, reg[e],
// thr[t]}.  Returns the number of passes, or -1 for j out of range.
int fhe_ntt_schedule(int logn, int j, int* out) {
    if (logn < 1 || logn > kMaxLogN || j < 0 || j >= num_passes(logn))
        return -1;
    const Pass ps = make_pass(logn, j);
    int k = 0;
    out[k++] = ps.lo;
    out[k++] = ps.hi;
    out[k++] = ps.e;
    out[k++] = ps.t;
    for (int i = 0; i < ps.e; ++i) out[k++] = ps.reg[i];
    for (int i = 0; i < ps.t; ++i) out[k++] = ps.thr[i];
    return num_passes(logn);
}

}  // extern "C"
