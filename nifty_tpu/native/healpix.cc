// HEALPix host-side geometry kernels (C++17, OpenMP-parallel).
//
// The framework keeps all *device* math in XLA; what remains
// native is construction-time geometry: pixel <-> angle maps, RING/NEST
// reordering, and neighbor tables for spherical refinement stencils.
// This mirrors the role ducc0's C++ healpix support plays for the
// reference (nifty/cl/operators/harmonic_operators.py:164,
// nifty/re/multi_grid/jhealpix.py) with an independent implementation of
// the published HEALPix algorithms (Gorski et al. 2005).
//
// Build: see build_native.py (plain g++ -O3 -shared -fopenmp).
// Binding: ctypes (see native/__init__.py); everything operates on
// contiguous arrays, batch-parallel.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

static const double PI = 3.141592653589793238462643383279502884;

// ---------------------------------------------------------------------------
// bit interleaving helpers for the NEST scheme
// ---------------------------------------------------------------------------

static inline std::uint64_t spread_bits(std::uint64_t v) {
  v &= 0xffffffffu;
  v = (v | (v << 16)) & 0x0000ffff0000ffffull;
  v = (v | (v << 8)) & 0x00ff00ff00ff00ffull;
  v = (v | (v << 4)) & 0x0f0f0f0f0f0f0f0full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

static inline std::uint64_t compress_bits(std::uint64_t v) {
  v &= 0x5555555555555555ull;
  v = (v | (v >> 1)) & 0x3333333333333333ull;
  v = (v | (v >> 2)) & 0x0f0f0f0f0f0f0f0full;
  v = (v | (v >> 4)) & 0x00ff00ff00ff00ffull;
  v = (v | (v >> 8)) & 0x0000ffff0000ffffull;
  v = (v | (v >> 16)) & 0x00000000ffffffffull;
  return v;
}

static inline std::int64_t xyf2nest(std::int64_t nside, std::int64_t ix,
                                    std::int64_t iy, int face) {
  return (std::int64_t)face * nside * nside +
         (std::int64_t)(spread_bits((std::uint64_t)ix) |
                        (spread_bits((std::uint64_t)iy) << 1));
}

static inline void nest2xyf(std::int64_t nside, std::int64_t pix,
                            std::int64_t *ix, std::int64_t *iy, int *face) {
  std::int64_t npface = nside * nside;
  *face = (int)(pix / npface);
  std::int64_t p = pix & (npface - 1);
  *ix = (std::int64_t)compress_bits((std::uint64_t)p);
  *iy = (std::int64_t)compress_bits((std::uint64_t)p >> 1);
}

// jrll/jpll: face "row" and "column" anchors (Gorski et al. Table)
static const int jrll[12] = {2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4};
static const int jpll[12] = {1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7};

// ---------------------------------------------------------------------------
// ring <-> xyf (the workhorse for RING/NEST conversion)
// ---------------------------------------------------------------------------

static inline std::int64_t xyf2ring(std::int64_t nside, std::int64_t ix,
                                    std::int64_t iy, int face) {
  std::int64_t jr = (std::int64_t)jrll[face] * nside - ix - iy - 1;  // ring 1..4n-1
  std::int64_t nr, kshift, n_before;
  std::int64_t ncap = 2 * nside * (nside - 1);
  std::int64_t npix = 12 * nside * nside;
  if (jr < nside) {  // north cap
    nr = jr;
    n_before = 2 * nr * (nr - 1);
    kshift = 0;
  } else if (jr > 3 * nside) {  // south cap
    nr = 4 * nside - jr;
    n_before = npix - 2 * nr * (nr + 1);
    kshift = 0;
  } else {  // equatorial
    nr = nside;
    n_before = ncap + (jr - nside) * 4 * nside;
    kshift = (jr - nside) & 1;
  }
  std::int64_t jp = ((std::int64_t)jpll[face] * nr + ix - iy + 1 + kshift) / 2;
  if (jp > 4 * nr) jp -= 4 * nr;
  if (jp < 1) jp += 4 * nr;
  return n_before + jp - 1;
}

static inline void ring2xyf(std::int64_t nside, std::int64_t pix,
                            std::int64_t *ix, std::int64_t *iy, int *face) {
  std::int64_t ncap = 2 * nside * (nside - 1);
  std::int64_t npix = 12 * nside * nside;
  std::int64_t iring, iphi, kshift, nr;
  int fn;
  if (pix < ncap) {  // north cap
    iring = (std::int64_t)(0.5 * (1.0 + std::sqrt((double)(1 + 2 * pix))));
    iphi = (pix + 1) - 2 * iring * (iring - 1);
    kshift = 0;
    nr = iring;
    fn = (int)((iphi - 1) / nr);
  } else if (pix < npix - ncap) {  // equatorial
    std::int64_t ip = pix - ncap;
    std::int64_t tmp = ip / (4 * nside);
    iring = tmp + nside;
    iphi = ip % (4 * nside) + 1;
    kshift = (iring + nside) & 1;
    std::int64_t ire = iring - nside + 1;
    std::int64_t irm = 2 * nside + 2 - ire;
    std::int64_t ifm = (iphi - ire / 2 + nside - 1) / nside;
    std::int64_t ifp = (iphi - irm / 2 + nside - 1) / nside;
    if (ifp == ifm)
      fn = (int)(ifp | 4);
    else if (ifp < ifm)
      fn = (int)ifp;
    else
      fn = (int)(ifm + 8);
    nr = nside;
  } else {  // south cap
    std::int64_t ip = npix - pix;
    iring = (std::int64_t)(0.5 * (1.0 + std::sqrt((double)(2 * ip - 1))));
    iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1));
    kshift = 0;
    nr = iring;
    fn = (int)(8 + (iphi - 1) / nr);
    iring = 4 * nside - iring;  // global ring index
  }
  std::int64_t irt = iring - ((std::int64_t)jrll[fn] * nside) + 1;
  std::int64_t ipt = 2 * iphi - (std::int64_t)jpll[fn] * nr - kshift - 1;
  if (ipt >= 2 * nside) ipt -= 8 * nside;
  *ix = (ipt - irt) >> 1;
  *iy = (-ipt - irt) >> 1;
  *face = fn;
}

// ---------------------------------------------------------------------------
// angle <-> pixel (RING)
// ---------------------------------------------------------------------------

static inline std::int64_t ang2pix_ring_one(std::int64_t nside, double z,
                                            double phi) {
  double za = std::fabs(z);
  double tt = std::fmod(phi / (0.5 * PI), 4.0);
  if (tt < 0) tt += 4.0;
  std::int64_t npix = 12 * nside * nside;
  if (za <= 2.0 / 3.0) {
    double temp1 = nside * (0.5 + tt);
    double temp2 = nside * 0.75 * z;
    std::int64_t jp = (std::int64_t)std::floor(temp1 - temp2);
    std::int64_t jm = (std::int64_t)std::floor(temp1 + temp2);
    std::int64_t ir = nside + 1 + jp - jm;  // 1..2n+1
    std::int64_t kshift = 1 - (ir & 1);
    std::int64_t ip = (jp + jm - nside + kshift + 1) / 2;
    ip = ip % (4 * nside);
    if (ip < 0) ip += 4 * nside;
    return 2 * nside * (nside - 1) + (ir - 1) * 4 * nside + ip;
  }
  double tp = tt - std::floor(tt);
  double tmp = nside * std::sqrt(3.0 * (1.0 - za));
  std::int64_t jp = (std::int64_t)std::floor(tp * tmp);
  std::int64_t jm = (std::int64_t)std::floor((1.0 - tp) * tmp);
  std::int64_t ir = jp + jm + 1;
  std::int64_t ip = (std::int64_t)std::floor(tt * ir);
  ip = ip % (4 * ir);
  if (ip < 0) ip += 4 * ir;
  if (z > 0)
    return 2 * ir * (ir - 1) + ip;
  return npix - 2 * ir * (ir + 1) + ip;
}

static inline void pix2ang_ring_one(std::int64_t nside, std::int64_t pix,
                                    double *z, double *phi) {
  std::int64_t ncap = 2 * nside * (nside - 1);
  std::int64_t npix = 12 * nside * nside;
  if (pix < ncap) {
    std::int64_t iring =
        (std::int64_t)(0.5 * (1.0 + std::sqrt((double)(1 + 2 * pix))));
    std::int64_t iphi = (pix + 1) - 2 * iring * (iring - 1);
    *z = 1.0 - (double)(iring * iring) / (3.0 * nside * nside);
    *phi = (iphi - 0.5) * PI / (2.0 * iring);
  } else if (pix < npix - ncap) {
    std::int64_t ip = pix - ncap;
    std::int64_t iring = ip / (4 * nside) + nside;
    std::int64_t iphi = ip % (4 * nside) + 1;
    double fodd = ((iring + nside) & 1) ? 1.0 : 0.5;
    *z = (2.0 * nside - iring) * 2.0 / (3.0 * nside);
    *phi = (iphi - fodd) * PI / (2.0 * nside);
  } else {
    std::int64_t ip = npix - pix;
    std::int64_t iring =
        (std::int64_t)(0.5 * (1.0 + std::sqrt((double)(2 * ip - 1))));
    std::int64_t iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1));
    *z = -1.0 + (double)(iring * iring) / (3.0 * nside * nside);
    *phi = (iphi - 0.5) * PI / (2.0 * iring);
  }
}

// ---------------------------------------------------------------------------
// NEST neighbors (face adjacency tables from the published algorithm)
// ---------------------------------------------------------------------------

static const int nb_xoffset[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
static const int nb_yoffset[8] = {0, 1, 1, 1, 0, -1, -1, -1};
// facearray[direction][face]: face landed on when leaving `face` in
// direction (S, SE, E, NE, N, NW, W, SW)
static const int nb_facearray[][12] = {
    {8, 9, 10, 11, -1, -1, -1, -1, 10, 11, 8, 9},    // S
    {5, 6, 7, 4, 8, 9, 10, 11, 9, 10, 11, 8},        // SE
    {-1, -1, -1, -1, 5, 6, 7, 4, -1, -1, -1, -1},    // E
    {4, 5, 6, 7, 11, 8, 9, 10, 11, 8, 9, 10},        // NE
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},          // center
    {1, 2, 3, 0, 0, 1, 2, 3, 5, 6, 7, 4},            // NW
    {-1, -1, -1, -1, 7, 4, 5, 6, -1, -1, -1, -1},    // W
    {3, 0, 1, 2, 3, 0, 1, 2, 4, 5, 6, 7},            // SW
    {2, 3, 0, 1, -1, -1, -1, -1, 0, 1, 2, 3}};       // N
static const int nb_swaparray[][3] = {
    {0, 0, 3}, {0, 0, 6}, {0, 0, 0}, {0, 0, 5}, {0, 0, 0},
    {5, 0, 0}, {0, 0, 0}, {6, 0, 0}, {3, 0, 0}};

static void neighbors_nest_one(std::int64_t nside, std::int64_t pix,
                               std::int64_t *out) {
  std::int64_t ix, iy;
  int face;
  nest2xyf(nside, pix, &ix, &iy, &face);
  const std::int64_t nsm1 = nside - 1;
  if (ix > 0 && ix < nsm1 && iy > 0 && iy < nsm1) {
    // interior fast path
    for (int m = 0; m < 8; ++m)
      out[m] =
          xyf2nest(nside, ix + nb_xoffset[m], iy + nb_yoffset[m], face);
    return;
  }
  for (int i = 0; i < 8; ++i) {
    std::int64_t x = ix + nb_xoffset[i];
    std::int64_t y = iy + nb_yoffset[i];
    int nbnum = 4;
    if (x < 0) {
      x += nside;
      nbnum -= 1;
    } else if (x >= nside) {
      x -= nside;
      nbnum += 1;
    }
    if (y < 0) {
      y += nside;
      nbnum -= 3;
    } else if (y >= nside) {
      y -= nside;
      nbnum += 3;
    }
    int f = nb_facearray[nbnum][face];
    if (f >= 0) {
      int bits = nb_swaparray[nbnum][face >> 2];
      if (bits & 1) x = nside - x - 1;
      if (bits & 2) y = nside - y - 1;
      if (bits & 4) {
        std::int64_t t = x;
        x = y;
        y = t;
      }
      out[i] = xyf2nest(nside, x, y, f);
    } else {
      out[i] = -1;  // no neighbor across this corner
    }
  }
}

// ---------------------------------------------------------------------------
// exported batch API
// ---------------------------------------------------------------------------

void healpix_ang2pix_ring(std::int64_t nside, const double *z,
                          const double *phi, std::int64_t n,
                          std::int64_t *pix) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i)
    pix[i] = ang2pix_ring_one(nside, z[i], phi[i]);
}

void healpix_pix2ang_ring(std::int64_t nside, const std::int64_t *pix,
                          std::int64_t n, double *z, double *phi) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i)
    pix2ang_ring_one(nside, pix[i], &z[i], &phi[i]);
}

void healpix_nest2ring(std::int64_t nside, const std::int64_t *pix,
                       std::int64_t n, std::int64_t *out) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i) {
    std::int64_t ix, iy;
    int face;
    nest2xyf(nside, pix[i], &ix, &iy, &face);
    out[i] = xyf2ring(nside, ix, iy, face);
  }
}

void healpix_ring2nest(std::int64_t nside, const std::int64_t *pix,
                       std::int64_t n, std::int64_t *out) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i) {
    std::int64_t ix, iy;
    int face;
    ring2xyf(nside, pix[i], &ix, &iy, &face);
    out[i] = xyf2nest(nside, ix, iy, face);
  }
}

void healpix_neighbors_nest(std::int64_t nside, const std::int64_t *pix,
                            std::int64_t n, std::int64_t *out /* n x 8 */) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i)
    neighbors_nest_one(nside, pix[i], out + 8 * i);
}

}  // extern "C"
