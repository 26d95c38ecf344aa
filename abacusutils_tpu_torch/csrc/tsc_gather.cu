// K1's multi-weight form: the TSC deposit of one point set, once for each of
// up to five weight columns, as a gather.
//
// Replaces abacusutils_tpu/ops/grid.py:paint_grouped_yb_multiw (five bias
// fields on the Zel'dovich lattice in the ZCV advection; JAX's own ZCV path
// paints them one get_field_fft at a time). The points are sorted once by
// the cell of their TSC stencil centre (ops/grid.py:stage_gather), in
// brick-major order: the key of cell (cx, cy, cz) is its brick's index
// times the GX x GY x GZ cells of a brick plus its index inside the brick,
// z fastest, so that the points of one brick are one contiguous range and
// those of a brick row's GZ cells too. `starts` holds the first point of
// every key. The stage packs each point into one or two 16-byte vectors: its
// per-axis offset d = i0 - g from its centre (the f32 steps of K1's
// axis_cloud, csrc/tsc_deposit.cu) in place of its coordinates, then its
// weight columns, so that a point costs one 32-byte sector to read.
//
// A block takes one brick of output cells; each warp a brick row, one lane
// a cell along z, so that the lanes' stores and the points they read are
// adjacent. For each of its cells a thread walks the 9 source rows of the
// stencil in a fixed order (x, then y offset), each over the three source
// cells along z as one loop (the cell below, its own, the cell above),
// wrapped periodically on every axis (so a mesh of 1 or 2 cells pulls one
// cell several times, with the weights of each offset, as the scatter adds
// them). It evaluates the per-axis weights of each point from its offsets,
// multiplies them in K1's association ((wx wy) w_f) wz, and adds the F
// columns' contributions in registers. Each grid cell is written once, with
// a plain store: no zeroing pass, no atomics, and the same bits on every
// launch. A unit-weight grid needs no column: (wx wy) 1 is wx wy exactly.
//
// What bounds it on the H100: reading the points, 27 times each (once for
// every cell of its stencil), from L1 and L2, and the lanes' uneven loops
// where cells hold uneven numbers of points: a warp runs as many iterations
// as its fullest three cells hold. The device-memory bytes (each point
// once, each grid cell written once) are the chip_smoke bound, which a
// gather of this kind does not approach. One loop of three cells a row, not
// three loops, cut the time 1.3x on the lattice and 3.7x on the advected
// lattice, where cells hold 0 to many points; a block's neighbourhood
// copied into shared memory first, or 27 loops a cell, are slower
// (scripts/torch/gather_variants.cu, scripts/torch/k1m_k7_compare.py
// --variants).
//
// Every product and sum is written with the _rn intrinsics, so nvcc cannot
// contract them into an FMA: each contribution equals K1's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int GX = 8, GY = 8, GZ = 32;  // the brick of output cells a block takes
constexpr int BRICK_CELLS = GX * GY * GZ;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(GZ == 32, "a warp takes one brick row of GZ cells");
// weight columns a stage packs
constexpr int MAX_WEIGHTS = 5;

// floats a staged point takes: d along x, y, z and NW weights, padded to
// one or two 16-byte vectors
__host__ __device__ constexpr int point_floats(int nw) { return 3 + nw <= 4 ? 4 : 8; }

// The TSC weight of stencil slot A (0: the cell below the centre, 1: the
// centre, 2: the cell above) of a point at offset d: K1's axis_cloud.
template <int A>
__device__ __forceinline__ float tsc_weight(float d) {
    if (A == 1) return __fsub_rn(0.75f, __fmul_rn(d, d));
    const float s = A == 0 ? __fadd_rn(0.5f, d) : __fsub_rn(0.5f, d);
    return __fmul_rn(0.5f, __fmul_rn(s, s));
}

__device__ __forceinline__ int wrap(int c, int n) { return c < 0 ? c + n : (c >= n ? c - n : c); }

// The TSC weight of the stencil slot known only at run time, the same bits
// as tsc_weight<slot>.
__device__ __forceinline__ float tsc_weight_at(int slot, float d) {
    const float s = slot == 0 ? __fadd_rn(0.5f, d) : __fsub_rn(0.5f, d);
    const float side = __fmul_rn(0.5f, __fmul_rn(s, s));
    const float mid = __fsub_rn(0.75f, __fmul_rn(d, d));
    return slot == 1 ? mid : side;
}

// The points of one source row's three cells along z (keys base + kz[0..2]:
// the cells below, at and above the output cell's z, slots 2, 1, 0) into the
// NF sums (the first a unit weight when UNIT, then the stage's weight
// columns in order), slot A along x and B along y. The three cells are one
// loop, so a warp runs as many iterations as its fullest three cells hold.
template <int NF, bool UNIT, int A, int B>
__device__ __forceinline__ void pull_row(float (&acc)[NF], int base, const int (&kz)[3],
                                         const int* __restrict__ starts,
                                         const float4* __restrict__ pts) {
    constexpr int NW = NF - UNIT;
    constexpr int V = point_floats(NW) / 4;  // float4s a point
    const int a0 = starts[base + kz[0]], a1 = starts[base + kz[0] + 1];
    const int b0 = starts[base + kz[1]], b1 = starts[base + kz[1] + 1];
    const int c0 = starts[base + kz[2]], c1 = starts[base + kz[2] + 1];
    const int na = a1 - a0, nab = na + b1 - b0, total = nab + c1 - c0;
    for (int t = 0; t < total; ++t) {
        const int p = t < na ? a0 + t : (t < nab ? b0 + t - na : c0 + t - nab);
        const float4 a = pts[V * p];
        float w[8] = {a.x, a.y, a.z, a.w};
        if constexpr (V == 2) {
            const float4 b = pts[V * p + 1];
            w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
        }
        const float wxy = __fmul_rn(tsc_weight<A>(w[0]), tsc_weight<B>(w[1]));
        const float wz = tsc_weight_at(t < na ? 2 : (t < nab ? 1 : 0), w[2]);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            const float wab = (UNIT && f == 0) ? wxy : __fmul_rn(wxy, w[3 + f - UNIT]);
            acc[f] = __fadd_rn(acc[f], __fmul_rn(wab, wz));
        }
    }
}

template <int NF, bool UNIT>
__global__ void __launch_bounds__(THREADS)
tsc_gather_kernel(float* __restrict__ grids, size_t grid_stride, const float4* __restrict__ pts,
                  const int* __restrict__ starts, int n, int nby, int nbz) {
    const int brick = blockIdx.x;
    const int bx = brick / (nby * nbz), by = (brick / nbz) % nby, bz = brick % nbz;
    const int cz = bz * GZ + (threadIdx.x & 31);
    if (cz >= n) return;  // the ragged last brick along z; the kernel has no barrier
    // the key parts of the three source cells along each axis (offset -1, 0, +1)
    int kz[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        const int c = wrap(cz + s - 1, n);
        kz[s] = (c / GZ) * BRICK_CELLS + c % GZ;
    }
    const int bricks_x = nby * nbz * BRICK_CELLS;
    for (int r = threadIdx.x >> 5; r < GX * GY; r += WARPS) {
        const int cx = bx * GX + r / GY, cy = by * GY + r % GY;
        if (cx >= n || cy >= n) continue;  // uniform across the warp
        int kx[3], ky[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            int c = wrap(cx + s - 1, n);
            kx[s] = (c / GX) * bricks_x + (c % GX) * (GY * GZ);
            c = wrap(cy + s - 1, n);
            ky[s] = (c / GY) * nbz * BRICK_CELLS + (c % GY) * GZ;
        }
        float acc[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] = 0.f;
        // source offset s - 1 on an axis is stencil slot 2 - s of its points
#define ROW(I, J) pull_row<NF, UNIT, 2 - I, 2 - J>(acc, kx[I] + ky[J], kz, starts, pts);
        ROW(0, 0) ROW(0, 1) ROW(0, 2) ROW(1, 0) ROW(1, 1) ROW(1, 2) ROW(2, 0) ROW(2, 1) ROW(2, 2)
#undef ROW
        const size_t cell = ((size_t)cx * n + cy) * n + cz;
#pragma unroll
        for (int f = 0; f < NF; ++f) grids[f * grid_stride + cell] = acc[f];
    }
}

// One dispatch over the instances: the kernel of nw weight columns, with a
// unit-weight grid first when `unit`; F is called with it.
template <typename F>
cudaError_t by_columns(int nw, int unit, F&& fn) {
    if (unit) {
        switch (nw) {
            case 0: return fn(tsc_gather_kernel<1, true>);
            case 1: return fn(tsc_gather_kernel<2, true>);
            case 2: return fn(tsc_gather_kernel<3, true>);
            case 3: return fn(tsc_gather_kernel<4, true>);
            case 4: return fn(tsc_gather_kernel<5, true>);
        }
    } else {
        switch (nw) {
            case 1: return fn(tsc_gather_kernel<1, false>);
            case 2: return fn(tsc_gather_kernel<2, false>);
            case 3: return fn(tsc_gather_kernel<3, false>);
            case 4: return fn(tsc_gather_kernel<4, false>);
            case 5: return fn(tsc_gather_kernel<5, false>);
        }
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// ---- host entries ----

// grids: (unit + nw) grids of nmesh^3 one after another, the unit-weight one
// first when `unit`; points: the stage's packed points, point_floats(nw)
// floats each (d along x, y, z, then the nw weights); starts: int32, the
// first point of every brick-major cell key and the end (nbricks * GX * GY
// * GZ + 1 entries); gx, gy, gz: the brick the stage keyed, which must be
// this file's.
extern "C" int tsc_gather_cells(float* grids, const float* points, int nw, int unit,
                                const int* starts, int nmesh, int gx, int gy, int gz,
                                void* stream) {
    if (nw < 0 || nw > MAX_WEIGHTS || unit + nw > MAX_WEIGHTS || gx != GX || gy != GY ||
        gz != GZ || nmesh < 1)
        return (int)cudaErrorInvalidValue;
    const int nbx = (nmesh + GX - 1) / GX, nby = (nmesh + GY - 1) / GY, nbz = (nmesh + GZ - 1) / GZ;
    const size_t stride = (size_t)nmesh * nmesh * nmesh;
    const float4* pts = reinterpret_cast<const float4*>(points);
    return (int)by_columns(nw, unit, [&](auto kernel) {
        kernel<<<nbx * nby * nbz, THREADS, 0, (cudaStream_t)stream>>>(grids, stride, pts, starts,
                                                                      nmesh, nby, nbz);
        return cudaGetLastError();
    });
}

// Resident blocks an SM holds for the kernel of nw weight columns and a unit
// grid when `unit` (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks.
extern "C" int tsc_gather_blocks_per_sm(int nw, int unit, int* blocks) {
    return (int)by_columns(nw, unit, [&](auto kernel) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, 0);
    });
}
