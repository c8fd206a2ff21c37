// Cell-list neighbor search (host-side large-system component).
//
// Host-side O(N) construction of padded neighbor lists for very large
// systems, replacing the O(N^2) in-jit top_k build (ops/nlist.py) when N is
// beyond what the distance matrix affords. The produced (idx, count) arrays
// feed the jitted model directly; displacements are recomputed from
// positions inside jit, so forces remain exact (the integer index lists are
// non-differentiable by nature).
//
// Semantics match the model's minimum-image convention: at most one edge
// per (i, j) pair, taken at the minimum image. The cell-list fast path is
// used when every axis spans >= 3 bins of size >= cutoff (the standard MD
// small-box constraint); smaller periodic boxes fall back to a brute-force
// MIC scan, aperiodic systems always use the cell list over the bounding
// box.
//
// C ABI loaded with ctypes by newtonnet_tpu_torch/data/prelists.py, built
// by g++ at first use (newtonnet_tpu_torch/ops/_build.py: load_host).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

void invert3(const double* m, double* inv) {
  double a = m[0], b = m[1], c = m[2];
  double d = m[3], e = m[4], f = m[5];
  double g = m[6], h = m[7], i = m[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  double id = 1.0 / det;
  inv[0] = (e * i - f * h) * id;
  inv[1] = (c * h - b * i) * id;
  inv[2] = (b * f - c * e) * id;
  inv[3] = (f * g - d * i) * id;
  inv[4] = (a * i - c * g) * id;
  inv[5] = (c * d - a * f) * id;
  inv[6] = (d * h - e * g) * id;
  inv[7] = (b * g - a * h) * id;
  inv[8] = (a * e - b * d) * id;
}

// d -= cell^T round(cell^-T d): exact row-convention MIC.
inline void mic(const double* cell, const double* inv, double* v) {
  double f0 = v[0] * inv[0] + v[1] * inv[3] + v[2] * inv[6];
  double f1 = v[0] * inv[1] + v[1] * inv[4] + v[2] * inv[7];
  double f2 = v[0] * inv[2] + v[1] * inv[5] + v[2] * inv[8];
  double n0 = std::nearbyint(f0), n1 = std::nearbyint(f1),
         n2 = std::nearbyint(f2);
  v[0] -= n0 * cell[0] + n1 * cell[3] + n2 * cell[6];
  v[1] -= n0 * cell[1] + n1 * cell[4] + n2 * cell[7];
  v[2] -= n0 * cell[2] + n1 * cell[5] + n2 * cell[8];
}

int64_t brute_force_mic(const double* pos, int64_t n, const double* cell,
                        const double* inv, double cutoff, int32_t k_max,
                        int32_t* idx, int32_t* count) {
  double r2 = cutoff * cutoff;
  int64_t overflow = 0;
  for (int64_t a = 0; a < n; ++a) {
    int32_t cnt = 0;
    const double* pa = pos + a * 3;
    for (int64_t j = 0; j < n; ++j) {
      if (j == a) continue;
      const double* pj = pos + j * 3;
      double v[3] = {pa[0] - pj[0], pa[1] - pj[1], pa[2] - pj[2]};
      mic(cell, inv, v);
      double dd = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
      if (dd < r2) {
        if (cnt < k_max)
          idx[a * k_max + cnt] = (int32_t)j;
        else
          overflow++;
        cnt++;
      }
    }
    count[a] = cnt < k_max ? cnt : k_max;
  }
  return overflow;
}

}  // namespace

extern "C" {

// Build a padded neighbor list (see file header).
//   pos: n*3, cell: 9 (rows; all-zero => aperiodic)
//   idx: out n*k_max (padded 0), count: out n
// Returns the number of dropped neighbors (in-range beyond k_max).
int64_t cell_list_neighbors(const double* pos, int64_t n, const double* cell,
                            double cutoff, int32_t k_max, int32_t* idx,
                            int32_t* count) {
  bool periodic = false;
  for (int i = 0; i < 9; ++i)
    if (cell[i] != 0.0) periodic = true;

  double inv[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  int nb[3] = {1, 1, 1};
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};

  if (periodic) {
    invert3(cell, inv);
    // cell heights: volume / face area
    for (int d = 0; d < 3; ++d) {
      const double* b1 = cell + ((d + 1) % 3) * 3;
      const double* b2 = cell + ((d + 2) % 3) * 3;
      double cx = b1[1] * b2[2] - b1[2] * b2[1];
      double cy = b1[2] * b2[0] - b1[0] * b2[2];
      double cz = b1[0] * b2[1] - b1[1] * b2[0];
      double area = std::sqrt(cx * cx + cy * cy + cz * cz);
      const double* b0 = cell + d * 3;
      double vol = std::fabs(b0[0] * cx + b0[1] * cy + b0[2] * cz);
      nb[d] = (int)std::floor(vol / area / cutoff);
    }
    if (nb[0] < 3 || nb[1] < 3 || nb[2] < 3)
      return brute_force_mic(pos, n, cell, inv, cutoff, k_max, idx, count);
  } else {
    for (int64_t a = 0; a < n; ++a)
      for (int d = 0; d < 3; ++d) {
        double v = pos[a * 3 + d];
        if (v < lo[d]) lo[d] = v;
        if (v > hi[d]) hi[d] = v;
      }
    for (int d = 0; d < 3; ++d) {
      double span = hi[d] - lo[d];
      nb[d] = span > cutoff ? (int)std::floor(span / cutoff) : 1;
    }
  }
  for (int d = 0; d < 3; ++d)
    if (nb[d] > 128) nb[d] = 128;
  int64_t nbins = (int64_t)nb[0] * nb[1] * nb[2];

  // bin assignment (fractional coords for periodic, bbox otherwise)
  std::vector<int32_t> bin_of(n);
  std::vector<int32_t> cell3(n * 3);
  std::vector<int32_t> bin_count(nbins, 0);
  auto bin_index = [&](int bx, int by, int bz) {
    return ((int64_t)bx * nb[1] + by) * nb[2] + bz;
  };
  for (int64_t a = 0; a < n; ++a) {
    const double* p = pos + a * 3;
    for (int d = 0; d < 3; ++d) {
      double t;
      if (periodic) {
        double fd = p[0] * inv[0 + d] + p[1] * inv[3 + d] + p[2] * inv[6 + d];
        t = fd - std::floor(fd);
      } else {
        t = hi[d] > lo[d] ? (p[d] - lo[d]) / (hi[d] - lo[d]) : 0.0;
      }
      int bi = (int)(t * nb[d]);
      if (bi >= nb[d]) bi = nb[d] - 1;
      if (bi < 0) bi = 0;
      cell3[a * 3 + d] = bi;
    }
    bin_of[a] =
        (int32_t)bin_index(cell3[a * 3], cell3[a * 3 + 1], cell3[a * 3 + 2]);
    bin_count[bin_of[a]]++;
  }
  std::vector<int64_t> bin_start(nbins + 1, 0);
  for (int64_t b = 0; b < nbins; ++b)
    bin_start[b + 1] = bin_start[b] + bin_count[b];
  std::vector<int32_t> bin_atoms(n);
  {
    std::vector<int64_t> cursor(bin_start.begin(), bin_start.end() - 1);
    for (int64_t a = 0; a < n; ++a)
      bin_atoms[cursor[bin_of[a]]++] = (int32_t)a;
  }

  double r2 = cutoff * cutoff;
  int64_t overflow = 0;
  for (int64_t a = 0; a < n; ++a) {
    const double* pa = pos + a * 3;
    int32_t cnt = 0;
    const int32_t* ab = &cell3[a * 3];
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          int bx = ab[0] + dx, by = ab[1] + dy, bz = ab[2] + dz;
          double shift[3] = {0, 0, 0};
          if (periodic) {
            int sx = 0, sy = 0, sz = 0;
            if (bx < 0) { bx += nb[0]; sx = -1; }
            if (bx >= nb[0]) { bx -= nb[0]; sx = 1; }
            if (by < 0) { by += nb[1]; sy = -1; }
            if (by >= nb[1]) { by -= nb[1]; sy = 1; }
            if (bz < 0) { bz += nb[2]; sz = -1; }
            if (bz >= nb[2]) { bz -= nb[2]; sz = 1; }
            for (int d = 0; d < 3; ++d)
              shift[d] =
                  sx * cell[0 + d] + sy * cell[3 + d] + sz * cell[6 + d];
          } else if (bx < 0 || bx >= nb[0] || by < 0 || by >= nb[1] ||
                     bz < 0 || bz >= nb[2]) {
            continue;
          }
          int64_t b = bin_index(bx, by, bz);
          for (int64_t s = bin_start[b]; s < bin_start[b + 1]; ++s) {
            int32_t j = bin_atoms[s];
            if (j == (int32_t)a) continue;  // nb>=3 => own images out of range
            const double* pj = pos + (int64_t)j * 3;
            // NOTE: positions are used as binned (wrapped) fractionals for
            // bin lookup, but the distance uses raw positions + bin shift;
            // raw positions must therefore be inside the cell for periodic
            // systems -- the Python wrapper wraps them first.
            double vx = pa[0] - (pj[0] + shift[0]);
            double vy = pa[1] - (pj[1] + shift[1]);
            double vz = pa[2] - (pj[2] + shift[2]);
            double dd = vx * vx + vy * vy + vz * vz;
            if (dd < r2) {
              if (cnt < k_max)
                idx[a * k_max + cnt] = j;
              else
                overflow++;
              cnt++;
            }
          }
        }
    count[a] = cnt < k_max ? cnt : k_max;
  }
  return overflow;
}

}  // extern "C"
