// Copied unchanged (below this note) from the JAX package's
// gtsam_petercdev_tpu/native/src/solve_native.cpp, to be built by the port's
// own g++ path (ops/build_host.py) into the port's _build/ directory.
//
// Native wildfire back-substitution sweep over the incremental Bayes tree.
//
// Replaces the Python frontier loop of IncrementalEngine._wildfire for the
// numpy backend: City10000-style trees are deep chains (depth ~ O(n)), so
// the sweep is inherently sequential and per-clique cost must be ~1 us to
// match the reference's recursion (gtsam/nonlinear/ISAM2Clique.cpp:237
// optimizeWildfireNode). Python-level per-clique dispatch costs ~100 us.
//
// Semantics mirror IncrementalEngine._wildfire exactly:
//   * seed cliques (the re-eliminated top) are recomputed unconditionally;
//   * a non-seed clique is recomputed iff any of its separator variables
//     is dirty (its frontal owner's delta changed > threshold);
//   * recomputation solves L^T x_F = y - W x_S via the cached diagonal
//     block inverses, writes x rows, and marks frontals dirty when
//     max|delta change| > threshold;
//   * descent only continues below recomputed cliques.
//
// All clique payload/topology state lives in flat per-cid arrays owned by
// the Python side (addresses passed per sweep); double precision only.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of cliques recomputed.
int64_t wildfire_sweep(
    int64_t n_cap,             // cid slots
    const int32_t* parent,     // [n_cap] parent cid or -1
    const uint8_t* alive,      // [n_cap]
    const int32_t* nf_arr,     // [n_cap] frontal STRIDE blocks (class nf)
    const int32_t* ns_arr,     // [n_cap] separator STRIDE blocks (class ns)
    const int32_t* nfr_arr,    // [n_cap] REAL frontal count (<= nf)
    const int32_t* nsr_arr,    // [n_cap] REAL separator count (<= ns)
    const uint64_t* pL,        // [n_cap] -> double[fd*fd]
    const uint64_t* pLinv,     // [n_cap] -> double[nf*d*d]
    const uint64_t* pW,        // [n_cap] -> double[fd*sd]
    const uint64_t* pY,        // [n_cap] -> double[fd]
    const int64_t* fro_off,    // [n_cap] offset into fro_buf
    const int64_t* sep_off,    // [n_cap] offset into sep_buf
    const int32_t* fro_buf,    // gids, nf entries per clique
    const int32_t* sep_buf,    // gids, ns entries per clique
    double* x,                 // [xcap+1, d] delta rows (gid-indexed)
    int64_t d,
    int64_t xcap,
    const int32_t* seeds,      // [n_seeds] cids forced to recompute
    int64_t n_seeds,
    double threshold,
    uint8_t* dirty,            // [xcap+1] scratch, zeroed by caller
    uint8_t* seed_mask,        // [n_cap] scratch, zeroed by caller
    double* scratch)           // [4 * max_fd] workspace
{
    // children adjacency (counting sort over parent pointers)
    std::vector<int32_t> child_cnt(n_cap + 1, 0);
    std::vector<int32_t> roots;
    for (int64_t c = 0; c < n_cap; ++c) {
        if (!alive[c]) continue;
        int32_t p = parent[c];
        if (p >= 0) child_cnt[p]++;
        else roots.push_back((int32_t)c);
    }
    std::vector<int32_t> child_off(n_cap + 1, 0);
    for (int64_t c = 0; c < n_cap; ++c)
        child_off[c + 1] = child_off[c] + child_cnt[c];
    std::vector<int32_t> child_buf(child_off[n_cap]);
    std::vector<int32_t> cur(child_cnt);
    for (int64_t c = 0; c < n_cap; ++c) {
        if (!alive[c]) continue;
        int32_t p = parent[c];
        if (p >= 0) child_buf[child_off[p] + (--cur[p], cur[p])] = (int32_t)c;
    }
    for (int64_t i = 0; i < n_seeds; ++i) seed_mask[seeds[i]] = 1;

    int64_t n_done = 0;
    std::vector<int32_t> stack(roots.rbegin(), roots.rend());
    while (!stack.empty()) {
        int32_t c = stack.back();
        stack.pop_back();
        const int32_t nf = nf_arr[c], ns = ns_arr[c];
        const int32_t nfr = nfr_arr[c], nsr = nsr_arr[c];
        const int64_t fd = (int64_t)nf * d, sd = (int64_t)ns * d;
        bool process = seed_mask[c] != 0;
        const int32_t* sep = sep_buf + sep_off[c];
        if (!process) {
            for (int32_t s = 0; s < nsr && !process; ++s)
                process = dirty[sep[s]] != 0;
        }
        if (!process) continue;  // do not descend below unprocessed cliques
        ++n_done;

        const double* L = (const double*)(uintptr_t)pL[c];
        const double* Linv = (const double*)(uintptr_t)pLinv[c];
        const double* W = (const double*)(uintptr_t)pW[c];
        const double* Y = (const double*)(uintptr_t)pY[c];
        const int32_t* fro = fro_buf + fro_off[c];

        double* rhs = scratch;            // [fd]
        double* xf = scratch + fd;        // [fd]
        // rhs = y - W @ x_sep
        std::memcpy(rhs, Y, fd * sizeof(double));
        for (int32_t s = 0; s < nsr; ++s) {
            const double* xs = x + (int64_t)sep[s] * d;
            const int64_t col0 = (int64_t)s * d;
            for (int64_t k = 0; k < d; ++k) {
                const double xv = xs[k];
                if (xv == 0.0) continue;
                const double* Wc = W;  // column (col0+k), stride sd
                for (int64_t f = 0; f < fd; ++f)
                    rhs[f] -= Wc[f * sd + col0 + k] * xv;
            }
        }
        // blocked back-substitution: L^T xf = rhs
        for (int32_t j = nf - 1; j >= 0; --j) {
            const int64_t jd = (int64_t)j * d;
            double rj[64];  // d <= 64
            for (int64_t k = 0; k < d; ++k) rj[k] = rhs[jd + k];
            // subtract strictly-lower contributions: rows f > jd+d-1 solved
            for (int64_t f = jd + d; f < fd; ++f) {
                const double xv = xf[f];
                if (xv == 0.0) continue;
                const double* Lr = L + f * fd + jd;
                for (int64_t k = 0; k < d; ++k) rj[k] -= Lr[k] * xv;
            }
            // xf_j = Linv_j^T rj
            const double* Lj = Linv + (int64_t)j * d * d;
            for (int64_t a = 0; a < d; ++a) {
                double acc = 0.0;
                for (int64_t k = 0; k < d; ++k) acc += Lj[k * d + a] * rj[k];
                xf[jd + a] = acc;
            }
        }
        // write x rows, track change, mark dirty frontals
        double chg = 0.0;
        for (int32_t fi = 0; fi < nfr; ++fi) {
            double* xr = x + (int64_t)fro[fi] * d;
            for (int64_t k = 0; k < d; ++k) {
                const double nv = xf[(int64_t)fi * d + k];
                const double dd_ = nv - xr[k];
                const double a = dd_ < 0 ? -dd_ : dd_;
                if (a > chg) chg = a;
                xr[k] = nv;
            }
        }
        if (chg > threshold)
            for (int32_t fi = 0; fi < nfr; ++fi) dirty[fro[fi]] = 1;
        for (int32_t i = child_off[c]; i < child_off[c + 1]; ++i)
            stack.push_back(child_buf[i]);
    }
    return n_done;
}

// ---------------------------------------------------------------------------
// Dense partial Cholesky of one level bucket (eager-numpy twin's native
// core). Mirrors kernels_np._partial_cholesky_loop semantics exactly:
// clamped pivots at eps, bad-pivot counting, same output layouts.
// Scalar right-looking factorization — the incremental engine's buckets are
// small (m <= ~100), where loop overhead beats BLAS dispatch by ~10x.
// ---------------------------------------------------------------------------


// ---------------------------------------------------------------------------
// Shared per-clique partial-Cholesky core. M is an m x m working copy
// (destroyed), g the m-vector. Writes L/Linv/W/y/U/ug in the engine's
// payload layouts; returns the clamped-pivot count.
// ---------------------------------------------------------------------------
static int64_t pchol_one(
    double* M, const double* g, int64_t m, int64_t nf, int64_t d, double eps,
    double* L, double* Linv, double* W, double* y, double* U, double* ug)
{
    const int64_t fd = nf * d;
    const int64_t sd = m - fd;
    int64_t bad = 0;
    for (int64_t j = 0; j < fd; ++j) {
        double piv = M[j * m + j];
        if (piv <= eps) { ++bad; piv = eps; }
        const double pj = __builtin_sqrt(piv);
        M[j * m + j] = pj;
        const double inv = 1.0 / pj;
        for (int64_t r = j + 1; r < m; ++r) M[r * m + j] *= inv;
        for (int64_t c = j + 1; c < m; ++c) {
            const double ljc = M[c * m + j];
            if (ljc == 0.0) continue;
            double* Mc = M + c;
            const double* Lj = M + j;
            for (int64_t r = c; r < m; ++r)
                Mc[r * m] -= Lj[r * m] * ljc;
        }
    }
    std::memset(L, 0, sizeof(double) * fd * fd);
    for (int64_t r = 0; r < fd; ++r)
        for (int64_t c = 0; c <= r; ++c) L[r * fd + c] = M[r * m + c];
    if (sd > 0) {
        for (int64_t s2 = 0; s2 < sd; ++s2)
            for (int64_t f = 0; f < fd; ++f)
                W[f * sd + s2] = M[(fd + s2) * m + f];
    }
    for (int64_t j = 0; j < fd; ++j) {
        double acc = g[j];
        const double* Lr = L + j * fd;
        for (int64_t k = 0; k < j; ++k) acc -= Lr[k] * y[k];
        y[j] = acc / Lr[j];
    }
    if (sd > 0) {
        for (int64_t r = 0; r < sd; ++r)
            for (int64_t c = 0; c <= r; ++c) {
                const double v = M[(fd + r) * m + (fd + c)];
                U[r * sd + c] = v;
                U[c * sd + r] = v;
            }
        for (int64_t s2 = 0; s2 < sd; ++s2) {
            double acc = g[fd + s2];
            for (int64_t f = 0; f < fd; ++f)
                acc -= W[f * sd + s2] * y[f];
            ug[s2] = acc;
        }
    }
    for (int64_t j = 0; j < nf; ++j) {
        const int64_t jd = j * d;
        double* X = Linv + j * d * d;
        std::memset(X, 0, sizeof(double) * d * d);
        for (int64_t c = 0; c < d; ++c) {
            X[c * d + c] = 1.0 / L[(jd + c) * fd + (jd + c)];
            for (int64_t r = c + 1; r < d; ++r) {
                double acc = 0.0;
                const double* Lr = L + (jd + r) * fd + jd;
                for (int64_t k = c; k < r; ++k) acc += Lr[k] * X[k * d + c];
                X[r * d + c] = -acc / Lr[r];
            }
        }
    }
    return bad;
}

extern "C" int64_t chol_bucket(
    const double* Fm,  // [B, m, m]
    const double* gm,  // [B, m]
    int64_t B, int64_t m, int64_t nf, int64_t d, double eps,
    double* Lout,      // [B, fd, fd]
    double* Linv,      // [B, nf, d, d]
    double* Wout,      // [B, fd, sd]
    double* yout,      // [B, fd]
    double* Uout,      // [B, sd, sd]
    double* ugout,     // [B, sd]
    double* work)      // [m*m + m]
{
    const int64_t fd = nf * d;
    const int64_t sd = m - fd;
    int64_t bad = 0;
    double* M = work;
    for (int64_t b = 0; b < B; ++b) {
        std::memcpy(M, Fm + b * m * m, sizeof(double) * m * m);
        bad += pchol_one(
            M, gm + b * m, m, nf, d, eps,
            Lout + b * fd * fd, Linv + b * nf * d * d,
            Wout + b * fd * sd, yout + b * fd,
            Uout + b * sd * sd, ugout + b * sd);
    }
    return bad;
}

// ---------------------------------------------------------------------------
// Whole bottom-up elimination sweep of one local re-elimination: per level,
// assemble each clique's frontal matrix straight out of the flat block pool
// (no Python-side reshape/transpose), factor it with pchol_one writing the
// outputs DIRECTLY into the clique's payload arrays, and extend-add the
// Schur complement back into the parent's pool blocks. One C call replaces
// ~30 numpy/scipy calls per update (the r5 City profile's remaining cost).
// ---------------------------------------------------------------------------
extern "C" int64_t eliminate_sweep(
    double* pool,              // [(n_blocks+1), d*d]
    double* gp,                // [(n_grows+1), d]
    int64_t d,
    int64_t n_levels,
    const int64_t* nf_arr,     // [n_levels]
    const int64_t* ns_arr,     // [n_levels]
    const int64_t* B_arr,      // [n_levels]
    const int64_t* boff_arr,   // [n_levels]
    const int64_t* goff_arr,   // [n_levels]
    const uint64_t* ext_ptr,   // [n_levels] -> int32[B, ns, ns] (parent blk)
    const uint64_t* extg_ptr,  // [n_levels] -> int32[B, ns] (parent g rows)
    const uint64_t* payL,      // [total_cliques] level-major payload ptrs
    const uint64_t* payLinv,
    const uint64_t* payW,
    const uint64_t* payY,
    const uint64_t* payU,
    const uint64_t* payUg,
    double eps,
    double* work)              // [max_m * (max_m + 1)]
{
    const int64_t dd = d * d;
    int64_t bad = 0;
    int64_t ci = 0;  // level-major clique cursor
    for (int64_t lv = 0; lv < n_levels; ++lv) {
        const int64_t nf = nf_arr[lv], ns = ns_arr[lv], B = B_arr[lv];
        const int64_t mb = nf + ns;
        const int64_t m = mb * d;
        const int64_t fd = nf * d, sd = ns * d;
        const int64_t boff = boff_arr[lv], goff = goff_arr[lv];
        const int32_t* ext = (const int32_t*)(uintptr_t)ext_ptr[lv];
        const int32_t* extg = (const int32_t*)(uintptr_t)extg_ptr[lv];
        double* M = work;
        double* g = work + m * m;
        for (int64_t i = 0; i < B; ++i, ++ci) {
            // gather the frontal matrix from the block pool
            const int64_t bbase = boff + i * mb * mb;
            for (int64_t p = 0; p < mb; ++p)
                for (int64_t q = 0; q < mb; ++q) {
                    const double* blk = pool + (bbase + p * mb + q) * dd;
                    double* Mrow = M + (p * d) * m + q * d;
                    for (int64_t a = 0; a < d; ++a)
                        for (int64_t b2 = 0; b2 < d; ++b2)
                            Mrow[a * m + b2] = blk[a * d + b2];
                }
            const double* gsrc = gp + (goff + i * mb) * d;
            std::memcpy(g, gsrc, sizeof(double) * m);
            double* U = (double*)(uintptr_t)payU[ci];
            double* ug = (double*)(uintptr_t)payUg[ci];
            bad += pchol_one(
                M, g, m, nf, d, eps,
                (double*)(uintptr_t)payL[ci],
                (double*)(uintptr_t)payLinv[ci],
                (double*)(uintptr_t)payW[ci],
                (double*)(uintptr_t)payY[ci],
                U, ug);
            // extend-add the Schur complement into the parent blocks
            if (sd > 0) {
                const int32_t* exti = ext + i * ns * ns;
                const int32_t* extgi = extg + i * ns;
                for (int64_t si = 0; si < ns; ++si) {
                    for (int64_t sj = 0; sj < ns; ++sj) {
                        double* dst = pool + (int64_t)exti[si * ns + sj] * dd;
                        const double* src = U + (si * d) * sd + sj * d;
                        for (int64_t a = 0; a < d; ++a)
                            for (int64_t b2 = 0; b2 < d; ++b2)
                                dst[a * d + b2] += src[a * sd + b2];
                    }
                    double* gdst = gp + (int64_t)extgi[si] * d;
                    const double* gsrc2 = ug + si * d;
                    for (int64_t a = 0; a < d; ++a) gdst[a] += gsrc2[a];
                }
            }
        }
    }
    return bad;
}

// Row-granular scatter-add: dst[rows[i]] += vals[i] (width w doubles per
// row); rows equal to `trash` are dropped. Replaces the deferred-bincount
// _NpAccum pass (np.add.at costs ~0.5 ms per call; one C pass is ~free).
extern "C" void scatter_add_rows(
    double* dst, const int64_t* rows, const double* vals,
    int64_t n, int64_t w, int64_t trash)
{
    for (int64_t i = 0; i < n; ++i) {
        const int64_t r = rows[i];
        if (r == trash) continue;
        double* dr = dst + r * w;
        const double* v = vals + i * w;
        for (int64_t k = 0; k < w; ++k) dr[k] += v[k];
    }
}

}  // extern "C"
