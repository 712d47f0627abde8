#include "optim.h"

#include <algorithm>
#include <cmath>

namespace hvdtpu {

// ------------------------------------------------------------------ cholesky
bool CholeskyFactor(std::vector<double>* A_io, int n) {
  std::vector<double>& A = *A_io;
  for (int j = 0; j < n; j++) {
    double d = A[j * n + j];
    for (int k = 0; k < j; k++) d -= A[j * n + k] * A[j * n + k];
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    A[j * n + j] = d;
    for (int i = j + 1; i < n; i++) {
      double s = A[i * n + j];
      for (int k = 0; k < j; k++) s -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = s / d;
    }
  }
  return true;
}

void CholeskySolveFactored(const std::vector<double>& L, int n,
                           std::vector<double> b, std::vector<double>* x) {
  // Forward solve L z = b.
  for (int i = 0; i < n; i++) {
    double s = b[i];
    for (int k = 0; k < i; k++) s -= L[i * n + k] * b[k];
    b[i] = s / L[i * n + i];
  }
  // Back solve L^T x = z.
  for (int i = n - 1; i >= 0; i--) {
    double s = b[i];
    for (int k = i + 1; k < n; k++) s -= L[k * n + i] * b[k];
    b[i] = s / L[i * n + i];
  }
  *x = std::move(b);
}

bool CholeskySolve(std::vector<double> A, int n, std::vector<double> b,
                   std::vector<double>* x) {
  if (!CholeskyFactor(&A, n)) return false;
  CholeskySolveFactored(A, n, std::move(b), x);
  return true;
}

// ------------------------------------------------------------------------ GP
double GaussianProcessRegressor::Kernel(const std::vector<double>& a,
                                        const std::vector<double>& b) const {
  double d2 = 0.0;
  for (size_t i = 0; i < a.size(); i++) {
    double d = a[i] - b[i];
    d2 += d * d;
  }
  return sigma_f_ * sigma_f_ * std::exp(-d2 / (2.0 * length_ * length_));
}

void GaussianProcessRegressor::Fit(const std::vector<std::vector<double>>& X,
                                   const std::vector<double>& y) {
  X_ = X;
  y_ = y;
  int n = static_cast<int>(X.size());
  y_mean_ = 0.0;
  for (double v : y) y_mean_ += v;
  y_mean_ /= std::max(n, 1);

  std::vector<double> K(static_cast<size_t>(n) * n, 0.0);
  for (int i = 0; i < n; i++) {
    for (int j = 0; j < n; j++) {
      K[i * n + j] = Kernel(X[i], X[j]) + (i == j ? noise_ : 0.0);
    }
  }
  std::vector<double> yc(n);
  for (int i = 0; i < n; i++) yc[i] = y[i] - y_mean_;
  // Factor once and cache; Predict reuses the factor for its O(n^2)
  // variance solves.  Escalating regularization on numerical failure; if
  // nothing makes K SPD, mark the model unfitted so Predict falls back to
  // the prior.
  L_ = K;
  bool ok = CholeskyFactor(&L_, n);
  double reg = 1e-2;
  while (!ok && reg <= 1e2) {
    for (int i = 0; i < n; i++) K[i * n + i] += reg;
    L_ = K;
    ok = CholeskyFactor(&L_, n);
    reg *= 100.0;
  }
  if (!ok) {
    X_.clear();
    alpha_.clear();
    L_.clear();
    return;
  }
  CholeskySolveFactored(L_, n, std::move(yc), &alpha_);
}

void GaussianProcessRegressor::Predict(const std::vector<double>& x,
                                       double* mean,
                                       double* variance) const {
  int n = static_cast<int>(X_.size());
  if (n == 0) {
    *mean = 0.0;
    *variance = sigma_f_ * sigma_f_;
    return;
  }
  std::vector<double> k(n);
  for (int i = 0; i < n; i++) k[i] = Kernel(x, X_[i]);
  double m = y_mean_;
  for (int i = 0; i < n; i++) m += k[i] * alpha_[i];
  *mean = m;
  // var = k(x,x) - k^T K^-1 k, via the factor cached by Fit.
  std::vector<double> v;
  CholeskySolveFactored(L_, n, k, &v);
  double q = 0.0;
  for (int i = 0; i < n; i++) q += k[i] * v[i];
  *variance = std::max(Kernel(x, x) - q, 1e-12);
}

// ------------------------------------------------------------------------ BO
namespace {
double NormCdf(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }
double NormPdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}
}  // namespace

void BayesianOptimizer::AddSample(const std::vector<double>& x, double y) {
  xs_.push_back(x);
  ys_.push_back(y);
  if (y > best_y_) {
    best_y_ = y;
    best_x_ = x;
  }
}

double BayesianOptimizer::ExpectedImprovement(
    const std::vector<double>& x, const GaussianProcessRegressor& gp,
    double incumbent) const {
  double mu, var;
  gp.Predict(x, &mu, &var);
  double sigma = std::sqrt(var);
  if (sigma < 1e-12) return 0.0;
  double imp = mu - incumbent - xi_;
  double z = imp / sigma;
  return imp * NormCdf(z) + sigma * NormPdf(z);
}

std::vector<double> BayesianOptimizer::NextSample(int candidates,
                                                 int min_samples) {
  std::uniform_real_distribution<double> u(0.0, 1.0);
  if (static_cast<int>(xs_.size()) < min_samples) {
    std::vector<double> x(dims_);
    for (int d = 0; d < dims_; d++) x[d] = u(rng_);
    return x;
  }
  // Normalize targets for GP conditioning.
  double lo = *std::min_element(ys_.begin(), ys_.end());
  double hi = *std::max_element(ys_.begin(), ys_.end());
  double span = std::max(hi - lo, 1e-12);
  std::vector<double> yn(ys_.size());
  for (size_t i = 0; i < ys_.size(); i++) yn[i] = (ys_[i] - lo) / span;

  GaussianProcessRegressor gp(0.3, 1.0, gp_noise_);
  gp.Fit(xs_, yn);

  // Dense EI argmax over uniform candidates + jittered incumbent; EI is
  // computed in normalized-y space.
  double best_ei = -1.0;
  std::vector<double> best(dims_, 0.5);
  std::normal_distribution<double> jitter(0.0, 0.05);
  double incumbent = (best_y_ - lo) / span;
  for (int c = 0; c < candidates; c++) {
    std::vector<double> x(dims_);
    if (c < candidates / 4 && !best_x_.empty()) {
      for (int d = 0; d < dims_; d++) {
        x[d] = std::min(1.0, std::max(0.0, best_x_[d] + jitter(rng_)));
      }
    } else {
      for (int d = 0; d < dims_; d++) x[d] = u(rng_);
    }
    double ei = ExpectedImprovement(x, gp, incumbent);
    if (ei > best_ei) {
      best_ei = ei;
      best = x;
    }
  }
  return best;
}

// --------------------------------------------------------------- arm bandit
ArmBandit::ArmBandit(int arms, int steps_per_sample, int max_pulls,
                     double explore)
    : arms_(arms > 0 ? arms : 1),
      steps_per_sample_(steps_per_sample > 0 ? steps_per_sample : 1),
      max_pulls_(max_pulls > 0 ? max_pulls : 4 * (arms > 0 ? arms : 1)),
      explore_(explore),
      mean_(arms_, 0.0),
      count_(arms_, 0) {
  if (arms_ == 1) done_ = true;  // nothing to choose
}

int ArmBandit::NextArm() const {
  // Round-robin until every arm has one pull, then UCB1 on means
  // normalized by the best mean (scores are unbounded bytes/sec; UCB1's
  // [0,1] assumption is recovered by the normalization).
  for (int i = 0; i < arms_; i++) {
    if (count_[i] == 0) return i;
  }
  double top = 1e-300;
  for (int i = 0; i < arms_; i++) top = std::max(top, mean_[i]);
  int best = 0;
  double best_ucb = -1e300;
  for (int i = 0; i < arms_; i++) {
    double ucb = mean_[i] / top +
                 explore_ * std::sqrt(2.0 * std::log(static_cast<double>(
                                          pulls_ + 1)) /
                                      count_[i]);
    if (ucb > best_ucb) {  // strict: ties keep the lower index
      best_ucb = ucb;
      best = i;
    }
  }
  return best;
}

bool ArmBandit::Update(double score) {
  if (done_) return false;
  sample_score_ += score;
  if (++steps_in_sample_ < steps_per_sample_) return false;

  double pull_score = sample_score_ / steps_in_sample_;
  count_[arm_]++;
  mean_[arm_] += (pull_score - mean_[arm_]) / count_[arm_];
  pulls_++;
  steps_in_sample_ = 0;
  sample_score_ = 0.0;

  if (static_cast<int>(pulls_) >= max_pulls_) {
    Finalize();
    return true;
  }
  int next = NextArm();
  bool changed = next != arm_;
  arm_ = next;
  return changed;
}

void ArmBandit::Finalize() {
  arm_ = best_arm();
  done_ = true;
}

int ArmBandit::best_arm() const {
  int best = 0;
  for (int i = 1; i < arms_; i++) {
    // Unpulled arms never beat observed ones; ties keep the lower index.
    if (count_[i] > 0 && (count_[best] == 0 || mean_[i] > mean_[best]))
      best = i;
  }
  return best;
}

double ArmBandit::best_mean() const {
  int b = best_arm();
  return count_[b] > 0 ? mean_[b] : 0.0;
}

// ------------------------------------------------------------ product bandit
ProductBandit::ProductBandit(int arms_a, int arms_b, int steps_per_sample,
                             int max_pulls, double explore)
    : arms_b_(arms_b > 0 ? arms_b : 1),
      inner_((arms_a > 0 ? arms_a : 1) * (arms_b > 0 ? arms_b : 1),
             steps_per_sample, max_pulls, explore) {}

bool ProductBandit::Update(double score) { return inner_.Update(score); }

// ------------------------------------------------------------ param manager
ParameterManager::ParameterManager(int64_t initial_threshold,
                                   double initial_cycle_ms,
                                   const Options& opts)
    : opts_(opts),
      opt_(2, 0.01, 42, opts.gp_noise),
      threshold_(initial_threshold),
      cycle_ms_(initial_cycle_ms),
      warmup_left_(static_cast<int>(opts.warmup_samples)) {}

std::vector<double> ParameterManager::CurrentPoint() const {
  // log-scale threshold, linear cycle time, both normalized to [0,1].
  double t = std::log2(static_cast<double>(threshold_) /
                       opts_.min_threshold) /
             std::log2(static_cast<double>(opts_.max_threshold) /
                       opts_.min_threshold);
  double c = (cycle_ms_ - opts_.min_cycle_ms) /
             (opts_.max_cycle_ms - opts_.min_cycle_ms);
  return {std::min(1.0, std::max(0.0, t)), std::min(1.0, std::max(0.0, c))};
}

void ParameterManager::ApplyPoint(const std::vector<double>& x) {
  double span = std::log2(static_cast<double>(opts_.max_threshold) /
                          opts_.min_threshold);
  threshold_ = static_cast<int64_t>(
      static_cast<double>(opts_.min_threshold) * std::pow(2.0, x[0] * span));
  cycle_ms_ = opts_.min_cycle_ms +
              x[1] * (opts_.max_cycle_ms - opts_.min_cycle_ms);
}

bool ParameterManager::Update(int64_t bytes, double seconds) {
  if (done_) return false;
  if (warmup_left_ > 0) {
    warmup_left_--;
    return false;
  }
  sample_bytes_ += bytes;
  sample_seconds_ += seconds;
  if (++steps_in_sample_ < opts_.steps_per_sample) return false;

  double score = sample_seconds_ > 0
                     ? static_cast<double>(sample_bytes_) / sample_seconds_
                     : 0.0;
  opt_.AddSample(CurrentPoint(), score);
  steps_in_sample_ = 0;
  sample_bytes_ = 0;
  sample_seconds_ = 0.0;

  if (static_cast<int>(opt_.num_samples()) >= opts_.bayes_opt_max_samples) {
    Finalize();
    return true;
  }
  ApplyPoint(opt_.NextSample());
  return true;
}

void ParameterManager::Finalize() {
  if (!opt_.best_x().empty()) ApplyPoint(opt_.best_x());
  done_ = true;
}

}  // namespace hvdtpu
