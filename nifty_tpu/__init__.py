"""nifty_tpu — a Bayesian field-inference framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of NIFTy
(NIFTy-PPL): hierarchical Gaussian-process generative models, likelihoods
with Fisher metrics, MGVI/geoVI variational inference, HMC/NUTS, and the
surrounding diagnostics — built for accelerators (device meshes,
collectives, fully-jittable solvers).

The public API mirrors ``nifty.re`` so reference users can switch with an
import swap.
"""

from . import conjugate_gradient, optimize
from .conjugate_gradient import CGResults, SteihaugResults, cg, cg_steihaug, static_cg
from .evi import (
    Samples,
    concatenate_zip,
    draw_linear_residual,
    draw_residual,
    nonlinearly_update_residual,
    sample_likelihood,
    wiener_filter_posterior,
)
from . import extra, hmc, lax, multi_grid, operators, plot
from .check_model import check_model
from .config_file import OptimizeKLConfig
from .empirical_power_spectrum import compute_empirical_power_spectrum
from .evidence_lower_bound import estimate_evidence_lower_bound
from .variational_models import FullCovarianceVI, MeanFieldVI
from .hmc import generate_hmc_acc_rej, generate_nuts_tree
from .hmc_oo import Chain, HMCChain, NUTSChain
from .mcmc import (
    LogDensity,
    blackjax_nuts,
    get_sample_size_estimate,
    nuts_sample,
)
from .likelihood import (
    Likelihood,
    LikelihoodPartial,
    LikelihoodSum,
    LikelihoodWithModel,
    StandardHamiltonian,
    partial_insert_and_remove,
)
from .likelihood_impl import (
    Bernoulli,
    Categorical,
    Gaussian,
    InverseGamma,
    NDVariableCovarianceGaussian,
    Poissonian,
    StudentT,
    VariableCovarianceGaussian,
    VariableCovarianceStudentT,
)
from .logger import logger
from .adjust_variances import adjust_variances
from .operator_spectrum import operator_spectrum
from .probing import StatCalculator, probe_diagonal, probe_with_posterior_samples
from .minisanity import ChiSqStats, minisanity, reduced_residual_stats
from .model import (
    ChainModel,
    ClipModel,
    Initializer,
    LazyModel,
    Model,
    RematModel,
    VModel,
    WrappedCall,
)
from .models.correlated_field import (
    CorrelatedFieldMaker,
    density_estimator,
    MaternAmplitude,
    NonParametricAmplitude,
    get_fourier_mode_distributor,
    get_spherical_mode_distributor,
    make_grid,
)
from .models.gauss_markov import (
    GaussMarkovProcess,
    IntegratedWienerProcess,
    OrnsteinUhlenbeckProcess,
    WienerProcess,
    discrete_gauss_markov_process,
    integrated_wiener_process,
    ornstein_uhlenbeck_process,
    wiener_process,
)
from .los import ExactGridLOS, SamplingCartesianGridLOS
from .models.dynamics import (
    dynamic_lightcone_operator,
    dynamic_operator,
    light_cone,
)
from .models.prior import (
    BetaPrior,
    GammaPrior,
    InvGammaPrior,
    LaplacePrior,
    LogInvGammaPrior,
    LogNormalPrior,
    NormalPrior,
    UniformPrior,
)
from .ops.nufft import nufft1, nufft2, nufft_adjoint
from .ski import HarmonicSKI, ToeplitzSKI, interp_mat, matmul_toeplitz
from .num.stats_distributions import (
    interpolator,
    invgamma_invprior,
    invgamma_prior,
    laplace_prior,
    lognormal_invprior,
    lognormal_moments,
    lognormal_prior,
    normal_invprior,
    normal_prior,
    uniform_prior,
)
from .optimize import (
    OptimizeResults,
    minimize,
    newton_cg,
    optax_wrapper,
    static_newton_cg,
    trust_ncg,
)
from .optimize_kl import OptimizeVI, OptimizeVIState, optimize_kl
from .ops.fft import hartley
from .utils.misc import hvp, interpolate, wrap, wrap_left
from .utils.pytree_string import PyTreeString, hide_strings
from .utils.tree import (
    ShapeWithDtype,
    Vector,
    assert_arithmetics,
    dot,
    get_map,
    lmap,
    map_forest,
    map_forest_mean,
    mean,
    mean_and_std,
    norm,
    ones_like,
    random_like,
    smap,
    stack,
    unstack,
    vdot,
    where,
    zeros_like,
)

__version__ = "0.1.0"
