// Gaussian-process regression + expected-improvement Bayesian optimization.
//
// Native re-implementation of the reference's autotune math (reference:
// horovod/common/optim/gaussian_process.{h,cc} — RBF-kernel GP with noise,
// horovod/common/optim/bayesian_optimization.{h,cc} — expected-improvement
// acquisition).  The reference leans on Eigen + vendored L-BFGS; the search
// space here is tiny (2-D), so the linear algebra is a hand-rolled Cholesky
// and the acquisition argmax is dense candidate sampling instead of L-BFGS
// restarts.  Zero dependencies.

#pragma once

#include <cstddef>
#include <random>
#include <vector>

namespace hvdtpu {

// In-place lower Cholesky factorization of row-major SPD A (LL^T).
// Returns false if the matrix is not SPD.
bool CholeskyFactor(std::vector<double>* A, int n);

// Solve L L^T x = b given a factor produced by CholeskyFactor.
void CholeskySolveFactored(const std::vector<double>& L, int n,
                           std::vector<double> b, std::vector<double>* x);

// Dense symmetric positive-definite solve via Cholesky (LL^T).
// Returns false if the matrix is not SPD.
bool CholeskySolve(std::vector<double> A, int n, std::vector<double> b,
                   std::vector<double>* x);

// RBF-kernel GP regressor with homoscedastic noise (reference:
// gaussian_process.h: kernel k(a,b)=sigma_f^2 exp(-|a-b|^2/(2 l^2))).
class GaussianProcessRegressor {
 public:
  explicit GaussianProcessRegressor(double length = 1.0, double sigma_f = 1.0,
                                    double noise = 1e-4)
      : length_(length), sigma_f_(sigma_f), noise_(noise) {}

  // Fit on normalized inputs X (n x d, row-major) and targets y (n).
  void Fit(const std::vector<std::vector<double>>& X,
           const std::vector<double>& y);

  // Posterior mean + variance at a point.
  void Predict(const std::vector<double>& x, double* mean,
               double* variance) const;

  bool fitted() const { return !X_.empty(); }

 private:
  double Kernel(const std::vector<double>& a,
                const std::vector<double>& b) const;

  double length_, sigma_f_, noise_;
  std::vector<std::vector<double>> X_;
  std::vector<double> alpha_;           // K^-1 y
  std::vector<double> L_;               // cached Cholesky factor of K+noise
  std::vector<double> y_;
  double y_mean_ = 0.0;
};

// Expected-improvement Bayesian optimizer over a [0,1]^d box
// (reference: bayesian_optimization.h; EI formula at
// bayesian_optimization.cc ExpectedImprovement).
class BayesianOptimizer {
 public:
  // gp_noise: observation-noise level for the internal GP conditioned on
  // [0,1]-normalized scores (reference uses ~0.8 for noisy throughput
  // samples, HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE).
  BayesianOptimizer(int dims, double xi = 0.01, unsigned seed = 42,
                    double gp_noise = 1e-4)
      : dims_(dims), xi_(xi), gp_noise_(gp_noise), rng_(seed) {}

  void AddSample(const std::vector<double>& x, double y);

  // Suggest the next point: EI argmax over `candidates` uniform draws
  // (plus the incumbent's neighborhood).  Pure exploration until
  // `min_samples` observations exist.
  std::vector<double> NextSample(int candidates = 256, int min_samples = 3);

  double best_y() const { return best_y_; }
  const std::vector<double>& best_x() const { return best_x_; }
  size_t num_samples() const { return xs_.size(); }

 private:
  double ExpectedImprovement(const std::vector<double>& x,
                             const GaussianProcessRegressor& gp,
                             double incumbent) const;

  int dims_;
  double xi_;
  double gp_noise_;
  std::mt19937 rng_;
  std::vector<std::vector<double>> xs_;
  std::vector<double> ys_;
  std::vector<double> best_x_;
  double best_y_ = -1e300;
};

// Deterministic UCB1 bandit over K discrete arms (the wire-policy
// dimension of autotune: arms are wire policies, scores are effective
// bytes/sec).  The continuous knobs (threshold, cycle) stay on the GP —
// a GP over a categorical axis would have to one-hot it and its RBF
// kernel would see unrelated policies as "near"; a bandit treats them
// as what they are.  No RNG: ties break toward the lower arm index, so
// replays and multi-process broadcasts can never diverge.
class ArmBandit {
 public:
  // steps_per_sample: steps aggregated into one pull's score (matches
  // the ParameterManager's sample cadence); max_pulls: total pulls
  // before freezing at the best-mean arm.
  ArmBandit(int arms, int steps_per_sample = 10, int max_pulls = 0,
            double explore = 0.5);

  // Record one step's score for the current arm.  Returns true when the
  // active arm changed (caller re-reads arm()) or the bandit finalized.
  bool Update(double score);

  // Freeze at the best observed mean arm.
  void Finalize();

  int arm() const { return arm_; }
  bool done() const { return done_; }
  int best_arm() const;
  double best_mean() const;
  size_t pulls() const { return pulls_; }

 private:
  int NextArm() const;

  int arms_;
  int steps_per_sample_;
  int max_pulls_;
  double explore_;
  int arm_ = 0;
  bool done_ = false;
  size_t pulls_ = 0;
  int steps_in_sample_ = 0;
  double sample_score_ = 0.0;
  std::vector<double> mean_;   // running mean score per arm
  std::vector<int> count_;     // pulls per arm
};

// Two-dimensional factored bandit: one deterministic UCB1 over the
// (arms_a x arms_b) product space with per-dimension arm decoding.  The
// dimensions are autotune's categorical axes — wire policy x overlap
// pipeline depth (ops/overlap.py) — searched JOINTLY, not per dimension:
// the best depth depends on the policy (an int8 wire shortens exactly
// the sync the pipeline is hiding).  Inherits ArmBandit's determinism
// (no RNG, ties to the lower flat index), so the decoded pair is safe to
// broadcast with the fusion threshold.
class ProductBandit {
 public:
  ProductBandit(int arms_a, int arms_b, int steps_per_sample = 10,
                int max_pulls = 0, double explore = 0.5);

  // Record one step's score for the current (a, b) pair.  Returns true
  // when the active pair changed or the bandit finalized.
  bool Update(double score);

  int arm_a() const { return inner_.arm() / arms_b_; }
  int arm_b() const { return inner_.arm() % arms_b_; }
  bool done() const { return inner_.done(); }
  size_t pulls() const { return inner_.pulls(); }
  int best_a() const { return inner_.best_arm() / arms_b_; }
  int best_b() const { return inner_.best_arm() % arms_b_; }

 private:
  int arms_b_;
  ArmBandit inner_;
};

// Autotuner for the runtime knobs (reference: parameter_manager.{h,cc}:
// tunes fusion threshold bytes + cycle time ms, scoring bytes/sec, with
// warmup discard and multi-cycle samples).
class ParameterManager {
 public:
  struct Options {
    double warmup_samples = 3;     // HOROVOD_AUTOTUNE_WARMUP_SAMPLES
    int steps_per_sample = 10;     // HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE
    int bayes_opt_max_samples = 20;  // HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES
    int64_t min_threshold = 1 << 20;        // 1 MiB
    int64_t max_threshold = 256LL << 20;    // 256 MiB
    double min_cycle_ms = 0.5;
    double max_cycle_ms = 50.0;
    double gp_noise = 0.8;  // HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE
  };

  ParameterManager(int64_t initial_threshold, double initial_cycle_ms,
                   const Options& opts);

  // Record `bytes` moved over `seconds`.  Returns true when the tunables
  // changed (caller re-reads threshold()/cycle_time_ms()).
  bool Update(int64_t bytes, double seconds);

  // Freeze at the best observed configuration.
  void Finalize();

  int64_t threshold() const { return threshold_; }
  double cycle_time_ms() const { return cycle_ms_; }
  bool done() const { return done_; }
  double best_score() const { return opt_.best_y(); }

 private:
  void ApplyPoint(const std::vector<double>& x);
  std::vector<double> CurrentPoint() const;

  Options opts_;
  BayesianOptimizer opt_;
  int64_t threshold_;
  double cycle_ms_;
  int warmup_left_;
  int steps_in_sample_ = 0;
  int64_t sample_bytes_ = 0;
  double sample_seconds_ = 0.0;
  bool done_ = false;
};

}  // namespace hvdtpu
