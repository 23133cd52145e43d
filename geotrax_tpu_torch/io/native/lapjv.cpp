// Jonker-Volgenant linear assignment solver of geotrax_tpu_torch: the
// port's copy of geotrax_tpu/io/native/lapjv.cpp, built with g++ at first
// use by io/native/__init__.py:build_plain and bound through ctypes by
// ops/assignment.py:lapjv_exact.
//
// Exact min-cost rectangular assignment (n rows <= m cols) by shortest
// augmenting paths with dual-variable maintenance, the algorithmic family
// of the lapx and scipy solvers. It runs on the host; the tracker's
// association runs the auction of ops/assignment.py on the device.
//
// C ABI:
//   int gtx_lapjv(const double* cost, int n, int m, long* row_to_col)
//     cost: row-major n*m, n <= m. row_to_col: out, length n.
//     Returns 0 on success, <0 on bad input.

#include <cstring>
#include <limits>
#include <vector>

extern "C" int gtx_lapjv(const double* cost, int n, int m, long* row_to_col) {
  if (n <= 0 || m < n) return -1;
  const double INF = std::numeric_limits<double>::infinity();

  std::vector<double> v(m, 0.0);     // column duals
  std::vector<int> col_owner(m, -1); // column -> row
  std::vector<int> row_col(n, -1);   // row -> column

  // Augment one row at a time via Dijkstra over columns.
  std::vector<double> dist(m);
  std::vector<int> pred(m);      // predecessor column's row along the path
  std::vector<char> done(m);

  for (int r = 0; r < n; ++r) {
    for (int j = 0; j < m; ++j) {
      dist[j] = cost[static_cast<size_t>(r) * m + j] - v[j];
      pred[j] = r;
      done[j] = 0;
    }
    int sink = -1;
    double sink_dist = 0.0;

    while (sink < 0) {
      // pick the closest unfinished column
      int jmin = -1;
      double dmin = INF;
      for (int j = 0; j < m; ++j) {
        if (!done[j] && dist[j] < dmin) {
          dmin = dist[j];
          jmin = j;
        }
      }
      if (jmin < 0) return -2;  // disconnected (cannot happen with finite costs)
      done[jmin] = 1;
      if (col_owner[jmin] < 0) {
        sink = jmin;
        sink_dist = dmin;
        break;
      }
      // relax through the row currently owning jmin
      int r2 = col_owner[jmin];
      for (int j = 0; j < m; ++j) {
        if (done[j]) continue;
        double nd = dmin + cost[static_cast<size_t>(r2) * m + j] - v[j] -
                    (cost[static_cast<size_t>(r2) * m + jmin] - v[jmin]);
        if (nd < dist[j]) {
          dist[j] = nd;
          pred[j] = r2;
        }
      }
    }

    // dual update for scanned columns
    for (int j = 0; j < m; ++j) {
      if (done[j] && j != sink) v[j] += dist[j] - sink_dist;
    }

    // augment along the alternating path back to row r
    int j = sink;
    while (true) {
      int pr = pred[j];
      col_owner[j] = pr;
      int next_j = row_col[pr];
      row_col[pr] = j;
      if (pr == r) break;
      j = next_j;
    }
  }

  for (int r = 0; r < n; ++r) row_to_col[r] = row_col[r];
  return 0;
}
