// Batched Jonker-Volgenant linear assignment solver and fixed-box NMS.
//
// Host-side native runtime of fpmatch_tpu_torch: the port's own copy of the
// JAX package's source (same algorithm, same code, so the two packages give
// the same assignments and the same kept boxes). The matcher keeps the LAP
// solve of the Hungarian discretization on the CPU, as the reference does
// (utils/hungarian.py: scipy + a multiprocessing pool); here it is one
// OpenMP-parallel batched call. The pore detector's NMS runs here too.
//
// Classic JV algorithm (Jonker & Volgenant, Computing 1987): column
// reduction, augmenting row reduction, then shortest augmenting paths.
// Solves min-cost square assignment; the Python wrapper negates scores and
// pads rectangles with a large constant.
//
// C ABI: batched float32, row-major.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Solve one n x n min-cost assignment. cost: row-major n*n.
// rowsol[i] = assigned column of row i.
void lapjv_single(int n, const float* cost, int* rowsol) {
  std::vector<int> colsol(n, -1);
  std::vector<double> u(n, 0.0), v(n, 0.0);
  std::vector<int> free_rows;
  free_rows.reserve(n);
  for (int i = 0; i < n; ++i) rowsol[i] = -1;

  // --- column reduction (scan columns right-to-left) ---
  for (int j = n - 1; j >= 0; --j) {
    double minv = cost[0 * n + j];
    int imin = 0;
    for (int i = 1; i < n; ++i) {
      double c = cost[i * n + j];
      if (c < minv) {
        minv = c;
        imin = i;
      }
    }
    v[j] = minv;
    if (rowsol[imin] == -1) {
      rowsol[imin] = j;
      colsol[j] = imin;
    }
  }

  // --- augmenting row reduction (two sweeps) ---
  for (int sweep = 0; sweep < 2; ++sweep) {
    std::vector<int> unassigned;
    for (int i = 0; i < n; ++i)
      if (rowsol[i] == -1) unassigned.push_back(i);
    for (int i : unassigned) {
      // find two smallest reduced costs in row i
      double min1 = DBL_MAX, min2 = DBL_MAX;
      int j1 = -1;
      for (int j = 0; j < n; ++j) {
        double c = cost[i * n + j] - v[j];
        if (c < min1) {
          min2 = min1;
          min1 = c;
          j1 = j;
        } else if (c < min2) {
          min2 = c;
        }
      }
      int i0 = colsol[j1];
      if (min1 < min2) {
        v[j1] -= (min2 - min1);
      } else if (i0 != -1) {
        // tie: try alternative column to avoid displacing
        continue;
      }
      if (i0 != -1) rowsol[i0] = -1;
      rowsol[i] = j1;
      colsol[j1] = i;
    }
  }

  for (int i = 0; i < n; ++i)
    if (rowsol[i] == -1) free_rows.push_back(i);

  // duals must satisfy u[i] + v[j] == cost[i][j] on assigned cells before
  // the augmentation phase (ARR-assigned rows have nonzero reduced cost)
  for (int i = 0; i < n; ++i)
    if (rowsol[i] != -1) u[i] = cost[i * n + rowsol[i]] - v[rowsol[i]];

  // --- shortest augmenting paths for remaining free rows ---
  std::vector<double> d(n);
  std::vector<int> pred(n);
  std::vector<char> done(n);
  for (int f : free_rows) {
    for (int j = 0; j < n; ++j) {
      d[j] = cost[f * n + j] - v[j];
      pred[j] = f;
      done[j] = 0;
    }
    int endj = -1;
    double mind = 0.0;
    std::vector<int> scanned;
    while (endj == -1) {
      // find min unscanned
      mind = DBL_MAX;
      int jmin = -1;
      for (int j = 0; j < n; ++j)
        if (!done[j] && d[j] < mind) {
          mind = d[j];
          jmin = j;
        }
      done[jmin] = 1;
      scanned.push_back(jmin);
      if (colsol[jmin] == -1) {
        endj = jmin;
        break;
      }
      int i = colsol[jmin];
      for (int j = 0; j < n; ++j) {
        if (done[j]) continue;
        double nd = mind + (cost[i * n + j] - u[i] - v[j]);
        if (nd < d[j]) {
          d[j] = nd;
          pred[j] = i;
        }
      }
    }
    // update duals for scanned columns
    for (int j : scanned) {
      if (j == endj) continue;
      v[j] += d[j] - mind;
    }
    // augment along the alternating path
    int j = endj;
    while (true) {
      int i = pred[j];
      colsol[j] = i;
      int jnew = rowsol[i];
      rowsol[i] = j;
      if (i == f) break;
      j = jnew;
    }
    // row duals
    for (int i = 0; i < n; ++i) {
      int jj = rowsol[i];
      if (jj != -1) u[i] = cost[i * n + jj] - v[jj];
    }
  }
}

}  // namespace

extern "C" {

// Batched solve: costs (b, n, n) row-major float32 → rowsol (b, n) int32.
void lapjv_batch(int32_t b, int32_t n, const float* costs, int32_t* rowsol) {
#pragma omp parallel for schedule(dynamic)
  for (int k = 0; k < b; ++k) {
    lapjv_single(n, costs + (int64_t)k * n * n, rowsol + (int64_t)k * n);
  }
}

// Greedy NMS over equal-size square boxes. coords (m, 2) int32 (y, x),
// scores (m,) float32. keep (m,) int32 output flags; returns kept count.
int32_t nms_fixed_boxes(int32_t m, const int32_t* coords, const float* scores,
                        int32_t box, float iou_thr, int32_t* keep) {
  std::vector<int> order(m);
  for (int i = 0; i < m; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int a, int b2) { return scores[a] > scores[b2]; });
  std::vector<char> dead(m, 0);
  std::memset(keep, 0, sizeof(int32_t) * m);
  const float area = (float)box * box;
  int kept = 0;
  for (int oi = 0; oi < m; ++oi) {
    int i = order[oi];
    if (dead[i]) continue;
    keep[i] = 1;
    ++kept;
    float yi = (float)coords[i * 2], xi = (float)coords[i * 2 + 1];
    for (int oj = oi + 1; oj < m; ++oj) {
      int j = order[oj];
      if (dead[j]) continue;
      float dy = yi - (float)coords[j * 2];
      float dx = xi - (float)coords[j * 2 + 1];
      float iy = box - (dy < 0 ? -dy : dy);
      float ix = box - (dx < 0 ? -dx : dx);
      if (iy <= 0 || ix <= 0) continue;
      float inter = iy * ix;
      float iou = inter / (2 * area - inter);
      if (iou > iou_thr) dead[j] = 1;
    }
  }
  return kept;
}

}  // extern "C"
