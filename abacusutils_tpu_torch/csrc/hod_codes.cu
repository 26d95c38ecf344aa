// The populate's priority keep codes: one pass over the halos (centrals) or
// the particles (satellites) that writes each object's int8 code.
//
// Replaces no TPU kernel: abacusutils_tpu/models/pipeline.py:_cent_codes and
// _sat_codes are elementwise jnp code that XLA fuses into one loop. The port
// ran them as a chain of ATen ops (models/hod/population.py:
// cent_codes_plain, sat_codes_plain): every 10**, log10, erfc, where, product
// and sum its own launch over 10^7 halos or 5x10^7 particles with a float32
// temporary written and read back, the three ELG conformity branches all
// computed, ~1.0 KB of traffic a particle. This kernel is that chain's one
// pass.
//
// Code c (1 LRG, 2 ELG, 3 QSO) goes to the first wanted tracer, in that
// order, whose running sum of markers reaches the object's random; 0 where
// none does. A thread takes kVec consecutive objects: it reads their columns
// once (float4 loads through the read-only path where every column is
// 16-byte aligned, else one float at a time), computes each marker with the
// f32 operations of the plain version in its order, and stops at the first
// code, which later tracers cannot change. A satellite reads its host's
// central code (ELG conformity) only when it reaches the ELG marker, as
// cent[host_at[i]] from the 10 MB code table (it stays in L2), or as
// cent[i] from a per-particle column, and computes only the branch (base,
// EL or EE) that code selects.
//
// Bits: every product, sum and quotient is an _rn intrinsic, so nvcc fuses
// nothing into an FMA, as ATen rounds after each op. 10**x and x**alpha
// are powf, log10 log10f, erfc erfcf, erf erff, exp expf: the CUDA math
// functions ATen's kernels call. x**2 is x * x (ATen's pow by 2). ATen
// divides by a Python float as a product by its f32 reciprocal (the
// divisions by SQRT2 and by sqrt(2.0), and by the 1.0 of Anorm), and a
// Python float by a tensor as the tensor's reciprocal times the float
// (1.0 / Q, INV_SQRT2PI / sigma); both are written out so. The codes equal
// the plain version's on the card bit for bit.
//
// Parameters: a pointer per (tracer, parameter) to the 0-d float32 tensors
// the plain version reads (convert.params_to_tensors; no copy, no sync),
// in population.py:CODE_PARAMS order, null where the form does not read it;
// a block copies the 72 values into shared memory once. Absent columns
// (shear; the four rank columns of satellites) are null pointers, and the
// tracers wanted are a bitmask.
//
// What bounds it on the H100: f32 instruction throughput, not bytes. A particle
// reads 24 B (hmass, weights, randoms, deltac, fenv, host_at) and 1 B of
// its host's code, and writes 1 B: 1.3 GB at 5x10^7, 0.38 ms at 3.35 TB/s.
// Its markers take up to 8 powf, a log10f, an erfcf and six IEEE
// divisions, of the order of 900 instructions; the kernel takes ~1.5 ms on
// the benchmark's 5x10^7 particles. Widths of 1, 2 and 4 objects a thread,
// the per-object code inlined or called, and register caps of 3 to 6
// blocks an SM all took 1.47-1.60 ms there (bit-equal): neither occupancy
// nor the loads hold it. kVec = 4 with the code inlined was the fastest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTracers = 3;  // population.py TRACER_ORDER
constexpr int kParams = 24;  // population.py CODE_PARAMS
constexpr int kCols = 10;    // population.py CODE_COLUMNS
constexpr int kVec = 4;
constexpr int kThreads = 256;

// population.py CODE_PARAMS, in order
enum {
    LOGM_CUT, ACENT, BCENT, CCENT, SIGMA, IC, P_MAX, Q, GAMMA, LOGM1, ASAT, BSAT, CSAT, ALPHA,
    KAPPA, A_S, LOGM1_EL, ALPHA_EL, LOGM1_EE, ALPHA_EE, S, S_V, S_P, S_R,
};

// population.py CODE_COLUMNS, in order: mass (hmass), multis (weights),
// randoms, deltac, fenv, shear, ranks, ranksv, ranksp, ranksr
enum { MASS, MULT, RANDOMS, DELTAC, FENV, SHEAR, RANK0 };

struct Columns {
    const float* c[kCols];
    const int* host_at;   // null: cent is per object
    const int8_t* cent;   // null where ELG is not wanted or for centrals
    long long ncent;      // cent's length
};

struct Params {
    const float* p[kTracers * kParams];
};

constexpr float kSqrt2 = 1.41421356f;          // shapes.SQRT2
constexpr float kRcpSqrt2 = 1.0f / 1.41421356f;  // ATen's x / SQRT2 and x / sqrt(2.0)
constexpr float kInvSqrt2Pi = 0.3989422804014327f;  // shapes.INV_SQRT2PI

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// a + A dc + B fe (+ C sh): the assembly-bias sum, left to right
__device__ __forceinline__ float ab3(float a, float A, float B, float dc, float fe) {
    return add(add(a, mul(A, dc)), mul(B, fe));
}

// shapes.N_sat_generic: x = M - kappa Mcut; 0 where x < 0, else
// A_s (x / M1)**alpha (A_s = 1 stands for the Python 1.0, a product that
// changes nothing)
__device__ __forceinline__ float sat_generic(float M, float Mcut, float kappa, float M1,
                                             float alpha, float A_s) {
    const float x = sub(M, mul(kappa, Mcut));
    const float b = x < 0.f ? 1.f : x;
    const float v = mul(A_s, powf(quo(b, M1), alpha));
    return x < 0.f ? 0.f : v;
}

// population.py:_cent_marker(tracer) * ic
__device__ float cent_marker(int t, const float* P, float M, float dc, float fe, float sh) {
    if (t == 1) {  // ELG: N_cen_ELG_v1
        const float lc = add(ab3(P[LOGM_CUT], P[ACENT], P[BCENT], dc, fe), mul(P[CCENT], sh));
        const float d = sub(log10f(M), lc);
        const float sig = P[SIGMA];
        const float phi = mul(mul(quo(1.f, sig), kInvSqrt2Pi),
                              expf(quo(mul(-mul(d, d), 0.5f), mul(sig, sig))));
        const float Phi = mul(0.5f, add(erff(mul(quo(mul(P[GAMMA], d), sig), kRcpSqrt2)), 1.f));
        const float c = mul(2.f, sub(P[P_MAX], mul(quo(1.f, P[Q]), 1.f)));
        return mul(mul(mul(mul(c, phi), Phi), 1.f), P[IC]);
    }
    const float lc = ab3(P[LOGM_CUT], P[ACENT], P[BCENT], dc, fe);
    float n;
    if (t == 0) {  // LRG: n_cen_LRG
        n = mul(0.5f, erfcf(quo(sub(lc, log10f(M)), mul(kSqrt2, P[SIGMA]))));
    } else {  // QSO: N_cen_QSO
        n = mul(0.5f, add(erff(quo(mul(sub(log10f(M), lc), kRcpSqrt2), P[SIGMA])), 1.f));
    }
    return mul(n, P[IC]);
}

// population.py:_sat_base(tracer); cent(), the host's central code, is
// read only by ELG
template <typename Cent>
__device__ float sat_base(int t, const float* P, float M, float dc, float fe, float sh,
                          Cent cent) {
    if (t == 0) {  // LRG: n_sat_LRG_modified
        const float M1 = powf(10.f, ab3(P[LOGM1], P[ASAT], P[BSAT], dc, fe));
        const float lc = ab3(P[LOGM_CUT], P[ACENT], P[BCENT], dc, fe);
        const float x = sub(M, mul(P[KAPPA], powf(10.f, lc)));
        const float b = x < 0.f ? 1.f : x;
        const float v = mul(mul(powf(quo(b, M1), P[ALPHA]), 0.5f),
                            erfcf(quo(sub(lc, log10f(M)), mul(kSqrt2, P[SIGMA]))));
        return x < 0.f ? 0.f : v;
    }
    if (t == 1) {  // ELG: N_sat_elg with conformity
        const float Mcut =
            powf(10.f, add(ab3(P[LOGM_CUT], P[ACENT], P[BCENT], dc, fe), mul(P[CCENT], sh)));
        const int kc = cent();
        float lm1, alpha;
        if (kc == 1) {
            lm1 = ab3(P[LOGM1_EL], P[ASAT], P[BSAT], dc, fe);
            alpha = P[ALPHA_EL];
        } else if (kc == 2) {
            lm1 = ab3(P[LOGM1_EE], P[ASAT], P[BSAT], dc, fe);
            alpha = P[ALPHA_EE];
        } else {
            lm1 = add(ab3(P[LOGM1], P[ASAT], P[BSAT], dc, fe), mul(P[CSAT], sh));
            alpha = P[ALPHA];
        }
        return sat_generic(M, Mcut, P[KAPPA], powf(10.f, lm1), alpha, P[A_S]);
    }
    // QSO: N_sat_generic
    const float M1 = powf(10.f, ab3(P[LOGM1], P[ASAT], P[BSAT], dc, fe));
    const float Mcut = powf(10.f, ab3(P[LOGM_CUT], P[ACENT], P[BCENT], dc, fe));
    return sat_generic(M, Mcut, P[KAPPA], M1, P[ALPHA], 1.f);
}

// one object's code from its columns (the absent ones 0)
template <bool kSat>
__device__ __forceinline__ int8_t keep_code(const float* par, int want, bool ranks, float M,
                                         float mult, float r, float dc, float fe, float sh,
                                         float r0, float r1, float r2, float r3,
                                         const int* host_at, const int8_t* cent,
                                         long long ncent, long long i) {
    float marker = 0.f;
    for (int t = 0; t < kTracers; ++t) {
        if (!(want >> t & 1)) continue;
        const float* P = par + t * kParams;
        float m;
        if (kSat) {
            auto code_of_host = [&]() -> int {
                const long long h = host_at ? __ldg(host_at + i) : i;
                // an index past the table stops the kernel, as ATen's gather does
                if (h < 0 || h >= ncent) __trap();
                return __ldg(cent + h);
            };
            m = mul(mul(sat_base(t, P, M, dc, fe, sh, code_of_host), mult), P[IC]);
            if (ranks) {
                m = mul(m, add(add(add(add(1.f, mul(P[S], r0)), mul(P[S_V], r1)),
                                   mul(P[S_P], r2)),
                               mul(P[S_R], r3)));
            }
        } else {
            m = mul(cent_marker(t, P, M, dc, fe, sh), mult);
        }
        marker = add(marker, m);
        if (r <= marker) return (int8_t)(t + 1);
    }
    return 0;
}

// kVec (4) consecutive floats from p, 16-byte aligned, in one load
__device__ __forceinline__ void load_vec(const float* p, float* v) {
    static_assert(kVec == 4, "one float4 a column");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
}

template <bool kSat>
__global__ void __launch_bounds__(kThreads)
hod_keep_codes_kernel(Columns cols, Params params, int want, long long n, int vec,
                      int8_t* __restrict__ out) {
    __shared__ float par[kTracers * kParams];
    for (int k = threadIdx.x; k < kTracers * kParams; k += blockDim.x)
        par[k] = params.p[k] ? __ldg(params.p[k]) : 0.f;
    __syncthreads();
    const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
    if (i0 >= n) return;
    const bool ranks = kSat && cols.c[RANK0] != nullptr;
    const int m = n - i0 < kVec ? (int)(n - i0) : kVec;
    const bool whole = vec && m == kVec;
    float v[kCols][kVec];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
        if (whole && cols.c[c]) {
            load_vec(cols.c[c] + i0, v[c]);
        } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j)
                v[c][j] = (j < m && cols.c[c]) ? __ldg(cols.c[c] + i0 + j) : 0.f;
        }
    }
    int8_t code[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
        code[j] = j < m ? keep_code<kSat>(par, want, ranks, v[MASS][j], v[MULT][j],
                                          v[RANDOMS][j], v[DELTAC][j], v[FENV][j], v[SHEAR][j],
                                          v[RANK0][j], v[RANK0 + 1][j], v[RANK0 + 2][j],
                                          v[RANK0 + 3][j], cols.host_at, cols.cent, cols.ncent,
                                          i0 + j)
                        : (int8_t)0;
    }
    if (whole) {
        *reinterpret_cast<char4*>(out + i0) = make_char4(code[0], code[1], code[2], code[3]);
    } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
            if (j < m) out[i0 + j] = code[j];
    }
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p % a) == 0; }

}  // namespace

// satellites (0: centrals), the kCols column pointers (population.py
// CODE_COLUMNS; null where absent), host_at (int32, or null: cent is per
// object), cent (int8 codes, or null) and its length, the kTracers x
// kParams parameter pointers (null where not read), the tracers wanted
// (bit t: TRACER_ORDER[t]),
// n (> 0), out (int8), stream
extern "C" int hod_keep_codes(int satellites, const void* const* columns, const void* host_at,
                              const void* cent, long long ncent, const void* const* params,
                              int want,
                              long long n, void* out, void* stream) {
    Columns cols;
    bool vec = aligned(out, kVec);
    for (int c = 0; c < kCols; ++c) {
        cols.c[c] = static_cast<const float*>(columns[c]);
        vec = vec && aligned(columns[c], 4 * kVec);
    }
    cols.host_at = static_cast<const int*>(host_at);
    cols.cent = static_cast<const int8_t*>(cent);
    cols.ncent = ncent;
    Params par;
    for (int k = 0; k < kTracers * kParams; ++k) par.p[k] = static_cast<const float*>(params[k]);
    const long long threads = (n + kVec - 1) / kVec;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    const cudaStream_t s = (cudaStream_t)stream;
    int8_t* o = static_cast<int8_t*>(out);
    if (satellites)
        hod_keep_codes_kernel<true><<<blocks, kThreads, 0, s>>>(cols, par, want, n, vec, o);
    else
        hod_keep_codes_kernel<false><<<blocks, kThreads, 0, s>>>(cols, par, want, n, vec, o);
    return (int)cudaGetLastError();
}
