// Approximate minimum-degree ordering (Amestoy, Davis and Duff, "An
// approximate minimum degree ordering algorithm", SIAM J. Matrix Anal. Appl.
// 17(4), 1996) on the variable graph of a factor graph, written for this
// repository. It is the port's fill-reducing ordering: the role CCOLAMD plays
// in the reference (inference/Ordering.cpp:55-126).
//
// The elimination runs on the quotient graph. Every uneliminated variable i
// keeps the elements E_i it touches and its variable neighbours A_i; an
// eliminated pivot p becomes the element L_p (the variables its elimination
// connects). At each step:
//   * the pivot is the principal variable of least approximate external
//     degree, in the lowest constraint group that still has variables
//     (CCOLAMD's cmember: group k is ordered before group k + 1); ties go to
//     the lowest variable id, so the result is deterministic;
//   * the pivot's whole supervariable is eliminated at once (mass
//     elimination), and the elements it touched are absorbed into L_p;
//   * for each i in L_p the lists are pruned (A_i loses L_p, E_i gains p),
//     any element whose variables all lie in L_p is absorbed (aggressive
//     absorption), and the degree becomes the AMD bound
//       min(n_left - |i|, d_i + |L_p \ i|,
//           |A_i \ i| + |L_p \ i| + sum_{e in E_i \ p} |L_e \ L_p|);
//   * variables of L_p with equal element and variable lists (and the same
//     constraint group) are merged into one supervariable, found by hashing.
// Dense rows get no special treatment. The result is the post-order of the
// assembly tree (the largest child subtree last, so chains stay contiguous),
// stably sorted by constraint group: a topological order of the same
// elimination tree, so it has the same fill.
//
// C ABI (ctypes): gtsam_amd_order(n, n_edges, edges [n_edges, 2] int64,
// cmember [n] int64 or null, perm_out [n] int64) -> 0, or -1 when an edge
// names a variable outside [0, n). perm_out[k] is the k-th variable eliminated.
#include <algorithm>
#include <cstdint>
#include <set>
#include <tuple>
#include <vector>

namespace {

struct Amd {
    int64_t n;
    std::vector<std::vector<int64_t>> A, E, L;  // variable nbrs, elements, element vars
    std::vector<int64_t> nv;                    // supervariable weight (0: merged away)
    std::vector<int64_t> deg;                   // approximate external degree
    std::vector<int64_t> grp;                   // constraint group
    std::vector<char> elim;                     // 1: eliminated (now an element)
    std::vector<char> absorbed;                 // element absorbed into a later one
    std::vector<int64_t> esize;                 // |L_e| (weighted), fixed at creation
    std::vector<int64_t> eparent;               // assembly tree parent of an element
    std::vector<int64_t> members;               // next variable of the same supervariable
    std::vector<int64_t> w;                     // |L_e \ L_p| during one step
    std::vector<int64_t> wstamp, mark;
    std::set<std::tuple<int64_t, int64_t, int64_t>> heap;  // (group, degree, id)
    std::vector<int64_t> pivots;                // elimination order of principal pivots

    Amd(int64_t n_) : n(n_), A(n_), E(n_), L(n_), nv(n_, 1), deg(n_, 0), grp(n_, 0),
                      elim(n_, 0), absorbed(n_, 0), esize(n_, 0), eparent(n_, -1),
                      members(n_, -1), w(n_, 0), wstamp(n_, -1), mark(n_, -1) {}

    bool alive_var(int64_t j) const { return !elim[j] && nv[j] > 0; }

    void run() {
        for (int64_t i = 0; i < n; ++i) {
            std::sort(A[i].begin(), A[i].end());
            A[i].erase(std::unique(A[i].begin(), A[i].end()), A[i].end());
            deg[i] = (int64_t)A[i].size();
            heap.insert({grp[i], deg[i], i});
        }
        int64_t n_left = n;
        int64_t step = 0;
        std::vector<int64_t> Lp;
        while (!heap.empty()) {
            const int64_t p = std::get<2>(*heap.begin());
            heap.erase(heap.begin());
            ++step;
            pivots.push_back(p);
            n_left -= nv[p];
            elim[p] = 1;
            // L_p = (A_p U the variables of every element of E_p) \ p
            Lp.clear();
            mark[p] = step;
            for (int64_t e : E[p]) {
                if (absorbed[e]) continue;
                for (int64_t j : L[e])
                    if (alive_var(j) && mark[j] != step) { mark[j] = step; Lp.push_back(j); }
                absorbed[e] = 1;
                eparent[e] = p;
                std::vector<int64_t>().swap(L[e]);
            }
            for (int64_t j : A[p])
                if (alive_var(j) && mark[j] != step) { mark[j] = step; Lp.push_back(j); }
            std::vector<int64_t>().swap(A[p]);
            std::vector<int64_t>().swap(E[p]);
            std::sort(Lp.begin(), Lp.end());
            int64_t lp_w = 0;
            for (int64_t i : Lp) {
                lp_w += nv[i];
                heap.erase({grp[i], deg[i], i});
            }
            L[p] = Lp;
            esize[p] = lp_w;
            // w(e) = |L_e \ L_p| for every element touching L_p
            for (int64_t i : Lp)
                for (int64_t e : E[i]) {
                    if (absorbed[e]) continue;
                    if (wstamp[e] != step) { wstamp[e] = step; w[e] = esize[e]; }
                    w[e] -= nv[i];
                }
            // prune the lists of L_p, absorb, bound the degrees
            std::vector<std::pair<uint64_t, int64_t>> hashed;
            hashed.reserve(Lp.size());
            for (int64_t i : Lp) {
                int64_t ext = 0;
                size_t k = 0;
                for (int64_t e : E[i]) {
                    if (absorbed[e]) continue;
                    if (w[e] == 0) {  // L_e within L_p: aggressive absorption
                        absorbed[e] = 1;
                        eparent[e] = p;
                        std::vector<int64_t>().swap(L[e]);
                        continue;
                    }
                    ext += w[e];
                    E[i][k++] = e;
                }
                E[i].resize(k);
                E[i].push_back(p);
                std::sort(E[i].begin(), E[i].end());
                int64_t a_w = 0;
                k = 0;
                for (int64_t j : A[i]) {
                    if (!alive_var(j) || mark[j] == step) continue;
                    a_w += nv[j];
                    A[i][k++] = j;
                }
                A[i].resize(k);  // stays sorted
                const int64_t rest = lp_w - nv[i];
                int64_t d = std::min(deg[i] + rest, a_w + rest + ext);
                d = std::min(d, n_left - nv[i]);
                deg[i] = std::max<int64_t>(d, 0);
                uint64_t h = (uint64_t)grp[i] * 0x9E3779B97F4A7C15ull;
                for (int64_t e : E[i]) h += (uint64_t)e * 0xBF58476D1CE4E5B9ull + 1;
                for (int64_t j : A[i]) h += (uint64_t)j * 0x94D049BB133111EBull + 7;
                hashed.push_back({h, i});
            }
            // supervariable detection among L_p: equal lists, equal group
            std::sort(hashed.begin(), hashed.end());
            for (size_t a = 0; a < hashed.size(); ) {
                size_t b = a;
                while (b < hashed.size() && hashed[b].first == hashed[a].first) ++b;
                for (size_t x = a; x < b; ++x) {
                    const int64_t i = hashed[x].second;
                    if (nv[i] == 0) continue;
                    for (size_t y = x + 1; y < b; ++y) {
                        const int64_t j = hashed[y].second;
                        if (nv[j] == 0 || grp[j] != grp[i] || E[j] != E[i] || A[j] != A[i])
                            continue;
                        // j joins i (i has the lower id: hashed runs are id-sorted)
                        int64_t t = i;
                        while (members[t] >= 0) t = members[t];
                        members[t] = j;
                        nv[i] += nv[j];
                        deg[i] = std::max<int64_t>(deg[i] - nv[j], 0);
                        nv[j] = 0;
                        std::vector<int64_t>().swap(A[j]);
                        std::vector<int64_t>().swap(E[j]);
                    }
                }
                a = b;
            }
            for (int64_t i : Lp)
                if (nv[i] > 0) heap.insert({grp[i], deg[i], i});
        }
    }

    // Post-order of the assembly tree (pivots as nodes), each pivot followed
    // by the rest of its supervariable in id order; then a stable sort by group.
    void order(int64_t* perm_out) {
        std::vector<int64_t> pos(n, -1);
        for (size_t k = 0; k < pivots.size(); ++k) pos[pivots[k]] = (int64_t)k;
        std::vector<std::vector<int64_t>> kids(n);
        std::vector<int64_t> roots;
        for (int64_t p : pivots) {
            if (eparent[p] >= 0) kids[eparent[p]].push_back(p);
            else roots.push_back(p);
        }
        // subtree weights (children are eliminated before their parents)
        std::vector<int64_t> wt(n, 0);
        for (int64_t p : pivots) {
            int64_t s = 0;
            for (int64_t t = p; t >= 0; t = members[t]) ++s;
            wt[p] += s;
            if (eparent[p] >= 0) wt[eparent[p]] += wt[p];
        }
        for (int64_t p : pivots) {
            auto& c = kids[p];
            if (c.size() < 2) continue;
            size_t big = 0;
            for (size_t k = 1; k < c.size(); ++k)
                if (wt[c[k]] >= wt[c[big]]) big = k;
            std::rotate(c.begin() + big, c.begin() + big + 1, c.end());
        }
        std::vector<int64_t> out;
        out.reserve(n);
        std::vector<std::pair<int64_t, size_t>> stack;
        for (int64_t r : roots) {
            stack.push_back({r, 0});
            while (!stack.empty()) {
                auto& top = stack.back();
                if (top.second < kids[top.first].size()) {
                    const int64_t c = kids[top.first][top.second++];
                    stack.push_back({c, 0});
                    continue;
                }
                const int64_t p = top.first;
                stack.pop_back();
                std::vector<int64_t> sv;
                for (int64_t t = p; t >= 0; t = members[t]) sv.push_back(t);
                std::sort(sv.begin() + 1, sv.end());
                out.insert(out.end(), sv.begin(), sv.end());
            }
        }
        std::stable_sort(out.begin(), out.end(),
                         [&](int64_t a, int64_t b) { return grp[a] < grp[b]; });
        std::copy(out.begin(), out.end(), perm_out);
    }
};

}  // namespace

extern "C" int64_t gtsam_amd_order(int64_t n, int64_t n_edges, const int64_t* edges,
                                   const int64_t* cmember, int64_t* perm_out) {
    if (n <= 0) return 0;
    Amd amd(n);
    for (int64_t k = 0; k < n_edges; ++k) {
        const int64_t a = edges[2 * k], b = edges[2 * k + 1];
        if (a < 0 || a >= n || b < 0 || b >= n) return -1;
        if (a == b) continue;
        amd.A[a].push_back(b);
        amd.A[b].push_back(a);
    }
    if (cmember)
        for (int64_t i = 0; i < n; ++i) amd.grp[i] = cmember[i];
    amd.run();
    amd.order(perm_out);
    return 0;
}
