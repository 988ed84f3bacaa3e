// Native host-side runtime components for mcmtt_opticalflow_tpu.
//
// The reference system is entirely native C++ (SURVEY.md §2); in this
// engine the compute path is JAX/XLA device code, and these C++ pieces
// cover the host-side roles where native code genuinely pays off:
//
//   * lap_solve        — exact Jonker-Volgenant linear assignment
//                        (host reference / fallback for the device auction;
//                        the reference's Munkres port is
//                        psn_where/helpers/PSNWhere_Hungarian.cpp:212-736)
//   * bls_mwcp_solve   — serial Breakout Local Search max-weight-clique,
//                        behaviourally matching the reference's
//                        hj::CGraphSolver (psn_where/GraphSolver.cpp:532-669)
//                        with a deterministic PRNG; used to cross-check the
//                        batched device solver and as a host backend
//   * parse_detections — fast parser for the PETS full-body detection text
//                        format (psn_where/PSNWhere_Utils.cpp:1051-1075)
//
// Exposed with a plain C ABI for ctypes.  Build: `make -C native`.

#include <algorithm>
#include <cctype>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Jonker-Volgenant LAP (dense, rectangular via padding, minimisation)
// ---------------------------------------------------------------------------
// cost: row-major [n_rows, n_cols]; forbidden entries = +inf (or >= 1e30).
// out_col_of_row: [n_rows], -1 when unmatched.  Returns total cost of the
// matched pairs.
double lap_solve(const double* cost, int n_rows, int n_cols,
                 int* out_col_of_row) {
    const double BIG = 1e30;
    int n = std::max(n_rows, n_cols);
    std::vector<double> a(static_cast<size_t>(n) * n, BIG);
    double maxfin = 0.0;
    for (int i = 0; i < n_rows * n_cols; ++i) {
        if (cost[i] < BIG && std::isfinite(cost[i]))
            maxfin = std::max(maxfin, cost[i]);
    }
    const double PAD = maxfin + 1.0;
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
            if (i < n_rows && j < n_cols) {
                double v = cost[i * n_cols + j];
                a[i * n + j] = (std::isfinite(v) && v < BIG) ? v : BIG;
            } else {
                a[i * n + j] = PAD;  // dummy row/col
            }
        }

    // Jonker-Volgenant with Dijkstra augmentation (shortest augmenting path)
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
    std::vector<int> p(n + 1, n), way(n + 1, 0);  // p[j] = row matched to col j
    for (int i = 0; i < n; ++i) {
        p[n] = i;
        int j0 = n;
        std::vector<double> minv(n + 1, DBL_MAX);
        std::vector<char> used(n + 1, 0);
        do {
            used[j0] = 1;
            int i0 = p[j0], j1 = -1;
            double delta = DBL_MAX;
            for (int j = 0; j < n; ++j) {
                if (used[j]) continue;
                double cur = a[i0 * n + j] - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (int j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else minv[j] -= delta;
            }
            j0 = j1;
        } while (p[j0] != n);
        do { int j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0 != n);
    }

    double total = 0.0;
    for (int i = 0; i < n_rows; ++i) out_col_of_row[i] = -1;
    for (int j = 0; j < n; ++j) {
        int i = p[j];
        if (i < n_rows && j < n_cols && a[i * n + j] < BIG / 2) {
            out_col_of_row[i] = j;
            total += a[i * n + j];
        }
    }
    return total;
}

// ---------------------------------------------------------------------------
// Serial BLS maximum-weight clique
// ---------------------------------------------------------------------------
// adj: row-major [n, n] 0/1 bytes; weights: [n].
// out_mask: [n] 0/1 best clique; out_sol_masks: [max_solutions, n] local
// optima (filled from best); out_sol_scores: [max_solutions].
// Returns the best score.  Deterministic for a given seed.
double bls_mwcp_solve(const double* weights, const uint8_t* adj, int n,
                      int max_iterations, uint64_t seed,
                      uint8_t* out_mask, int max_solutions,
                      uint8_t* out_sol_masks, double* out_sol_scores,
                      int* out_num_solutions) {
    std::mt19937_64 rng(seed);
    auto urand = [&]() {
        return std::uniform_real_distribution<double>(0.0, 1.0)(rng); };

    std::vector<char> in_c(n, 0);
    std::vector<int> cnt(n, 0);       // neighbours in C
    std::vector<long long> tabu(n, 0);
    auto adj_at = [&](int i, int j) { return adj[(size_t)i * n + j] != 0; };

    auto insert_v = [&](int v_) {
        in_c[v_] = 1;
        for (int u_ = 0; u_ < n; ++u_) if (adj_at(v_, u_)) cnt[u_]++;
    };
    auto remove_v = [&](int v_) {
        in_c[v_] = 0;
        for (int u_ = 0; u_ < n; ++u_) if (adj_at(v_, u_)) cnt[u_]--;
    };
    auto csize = [&]() {
        return std::count(in_c.begin(), in_c.end(), (char)1); };
    auto score = [&]() {
        double s = 0;
        for (int i = 0; i < n; ++i) if (in_c[i]) s += weights[i];
        return s;
    };

    // greedy weight-descending initial solution (ref GraphSolver.cpp:986-1090)
    {
        std::vector<int> order(n);
        std::iota(order.begin(), order.end(), 0);
        std::sort(order.begin(), order.end(), [&](int x, int y) {
            return weights[x] > weights[y]; });
        int cs = 0;
        for (int idx : order) {
            if (weights[idx] >= 0 && cnt[idx] == cs) { insert_v(idx); cs++; }
        }
    }

    std::vector<std::vector<char>> sols;
    std::vector<double> sol_scores;
    auto record = [&](double sc) {
        if (sc <= 0.0) return;
        for (size_t k = 0; k < sols.size(); ++k) {
            if (std::fabs(sol_scores[k] - sc) < 1e-5 &&
                std::equal(sols[k].begin(), sols[k].end(), in_c.begin()))
                return;
        }
        sols.emplace_back(in_c.begin(), in_c.end());
        sol_scores.push_back(sc);
    };

    double fbest = score();
    std::vector<char> best(in_c);
    std::vector<char> cp(in_c);
    record(fbest);

    const int T = 10;
    const double P0 = 0.75;
    const int PHI = 7;
    double L0 = std::max(0.01 * n, 1.0), Lmax = std::max(0.10 * n, 2.0);
    double L = 0;
    int w = 0;
    long long iter = 0;

    while (iter < max_iterations) {
        // ---- best-improvement local search (ref BLS_BestLocalMove) -------
        for (;;) {
            int cs = csize();
            double best_gain = 1e-12;
            int vi = -1, vr = -1;
            for (int v_ = 0; v_ < n; ++v_) {
                if (in_c[v_]) continue;
                if (cnt[v_] == cs) {                       // PA insert
                    if (weights[v_] > best_gain) {
                        best_gain = weights[v_]; vi = v_; vr = -1;
                    }
                } else if (cnt[v_] == cs - 1 && cs > 0) {  // OM swap
                    int partner = -1;
                    for (int u_ = 0; u_ < n; ++u_)
                        if (in_c[u_] && !adj_at(v_, u_)) { partner = u_; break; }
                    double g = weights[v_] - weights[partner];
                    if (g > best_gain) { best_gain = g; vi = v_; vr = partner; }
                }
            }
            if (vi < 0 || iter >= max_iterations) break;
            if (vr >= 0) remove_v(vr);
            insert_v(vi);
            iter++;
        }
        double fc = score();
        if (fc > fbest) { fbest = fc; best.assign(in_c.begin(), in_c.end()); w = 0; }
        else w++;

        bool esc = w > T;
        bool same = std::equal(in_c.begin(), in_c.end(), cp.begin());
        if (esc) { L = Lmax; w = 0; }
        else if (same) { L += 1; }
        else { record(fc); L = L0; }
        cp.assign(in_c.begin(), in_c.end());

        // ---- perturbation (ref BLS_Perturbation :1173-1184) --------------
        double P = (w == 0) ? 0.0 : std::min(std::exp(-(double)w / T), P0);
        bool directed = urand() < P;
        for (int step = 0; step < (int)L && iter < max_iterations; ++step) {
            int cs = csize();
            if (directed) {
                std::vector<std::pair<int, int>> moves;  // (v, remove)
                for (int v_ = 0; v_ < n; ++v_) {
                    if (in_c[v_]) { moves.push_back({v_, 1}); continue; }
                    if (tabu[v_] > iter) continue;
                    if (cnt[v_] == cs) moves.push_back({v_, 0});
                    else if (cnt[v_] == cs - 1 && cs > 0) moves.push_back({v_, 2});
                }
                if (moves.empty()) { iter++; break; }
                auto mv = moves[(size_t)(urand() * (moves.size() - 1))];
                int om_count = 0;
                for (int v_ = 0; v_ < n; ++v_)
                    if (!in_c[v_] && cnt[v_] == cs - 1) om_count++;
                long long tenure = PHI + (long long)(urand() * std::max(om_count, 1));
                if (mv.second == 1) { remove_v(mv.first); tabu[mv.first] = iter + tenure; }
                else if (mv.second == 0) insert_v(mv.first);
                else {
                    int partner = -1;
                    for (int u_ = 0; u_ < n; ++u_)
                        if (in_c[u_] && !adj_at(mv.first, u_)) { partner = u_; break; }
                    if (partner >= 0) { remove_v(partner); tabu[partner] = iter + tenure; }
                    insert_v(mv.first);
                }
            } else {
                double fc2 = score();
                double alpha = 0.8;
                std::vector<int> moves;
                for (int v_ = 0; v_ < n; ++v_) {
                    if (in_c[v_]) continue;
                    if (tabu[v_] <= iter) { moves.push_back(v_); continue; }
                    double nb = 0;
                    for (int u_ = 0; u_ < n; ++u_)
                        if (in_c[u_] && adj_at(v_, u_)) nb += weights[u_];
                    if (nb >= alpha * fc2) moves.push_back(v_);
                }
                if (moves.empty()) { iter++; break; }
                int v_ = moves[(size_t)(urand() * (moves.size() - 1))];
                // M4 repair: remove non-neighbours of v_, insert v_
                for (int u_ = 0; u_ < n; ++u_)
                    if (in_c[u_] && !adj_at(v_, u_)) remove_v(u_);
                insert_v(v_);
            }
            iter++;
        }
    }

    record(score());
    // best solution into ring output, sorted by score descending
    std::vector<size_t> order(sols.size());
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(), [&](size_t x, size_t y) {
        return sol_scores[x] > sol_scores[y]; });
    int m = std::min<int>((int)sols.size(), max_solutions);
    for (int k = 0; k < m; ++k) {
        out_sol_scores[k] = sol_scores[order[k]];
        for (int i = 0; i < n; ++i)
            out_sol_masks[(size_t)k * n + i] = sols[order[k]][i];
    }
    *out_num_solutions = m;
    for (int i = 0; i < n; ++i) out_mask[i] = best[i];
    return fbest;
}

// ---------------------------------------------------------------------------
// PETS full-body detection text parser
// ---------------------------------------------------------------------------
// Parses "numBoxes:N {\n\tROOT:{x,y,w,h} ...}" files
// (format: psn_where/PSNWhere_Utils.cpp:1051-1075).
// out_boxes: caller-allocated [max_boxes * 4].  Returns the box count
// (<0 on error).
int parse_detections(const char* text, double* out_boxes, int max_boxes) {
    const char* p = std::strstr(text, "numBoxes:");
    if (!p) return -1;
    int declared = std::atoi(p + 9);
    int count = 0;
    const char* cur = p;
    while (count < max_boxes && count < declared) {
        cur = std::strstr(cur, "ROOT:{");
        if (!cur) break;
        cur += 6;
        double vals[4];
        for (int k = 0; k < 4; ++k) {
            char* end = nullptr;
            vals[k] = std::strtod(cur, &end);
            if (end == cur) return count;
            cur = end;
            while (*cur == ',' || *cur == ' ') cur++;
        }
        for (int k = 0; k < 4; ++k) out_boxes[count * 4 + k] = vals[k];
        count++;
    }
    return count;
}

// ---------------------------------------------------------------------------
// 8-bit RGB -> gray, (r + g + b) / 3 truncating
// ---------------------------------------------------------------------------
// The per-frame host ingest path (the engine uploads 8-bit gray only; the
// reference feeds cvtColor CV_8U gray to its LK stage,
// psn_where/PSNWhere_Tracker2D.cpp:256-262).  Memory-bound: one pass,
// ~7 MB per 4-camera 768x576 frame — the numpy uint16 formulation this
// replaces spent ~10 ms/frame on temporaries.
void rgb_to_gray_u8(const unsigned char* rgb, long long num_pixels,
                    unsigned char* gray) {
    long long i = 0;
    const unsigned char* p = rgb;
    for (; i + 4 <= num_pixels; i += 4, p += 12) {
        gray[i] = (unsigned char)(((unsigned)p[0] + p[1] + p[2]) / 3u);
        gray[i + 1] = (unsigned char)(((unsigned)p[3] + p[4] + p[5]) / 3u);
        gray[i + 2] = (unsigned char)(((unsigned)p[6] + p[7] + p[8]) / 3u);
        gray[i + 3] = (unsigned char)(((unsigned)p[9] + p[10] + p[11]) / 3u);
    }
    for (; i < num_pixels; ++i)
        gray[i] = (unsigned char)(((unsigned)rgb[3 * i] + rgb[3 * i + 1]
                                   + rgb[3 * i + 2]) / 3u);
}

}  // extern "C"
