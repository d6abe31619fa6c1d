"""adaprox_tpu — an adaptive proximal-algorithm framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
pylat/adaptive-proximal-algorithms (the official code of "Adaptive proximal
algorithms for convex optimization under local Lipschitz continuity of the
gradient", arXiv:2301.04431): the AdaPGM/AdaPDM family of adaptive-stepsize
solvers for composite problems

    minimize_x  f(x) + g(x) + h(A x)

plus linesearch/backtracking baselines, oracle-call metering, the JSONL
telemetry schema, and the full benchmark-problem suite — running as compiled
``lax.scan``/``while_loop`` programs on the GPU whose sharded problems communicate only a handful of psum-reduced scalars per
iteration.

Layout (see SURVEY.md for the reference layer map):
  ops/        function/operator calculus: prox library, smooth oracles,
              linear operators, the one-pass GPU kernel
  solvers/    stepsize rules + the 12 solver entry points
  models/     benchmark objectives and problem generators
  parallel/   mesh/sharding helpers for multi-device execution
  utils/      counting wrappers, JSONL telemetry, LIBSVM IO
  experiments/ the reference experiment grid, reproduced end to end
"""

from .ops.prox import (
    Zero,
    L1Norm,
    L2Norm,
    SqrL2Norm,
    IndBox,
    IndBall2,
    IndZero,
    ElasticNet,
    GroupL2,
    IndSimplex,
    IndBall1,
    LInfNorm,
    Huber,
    NuclearNorm,
    IndPSD,
    HingeLoss,
    LogBarrier,
    IndHalfspace,
    IndHyperplane,
    SeparableSum,
    Scale,
    Translate,
    MoreauConjugate,
    conjugate,
)
from .ops.oracles import SmoothOracle, FromFunction, ZeroSmooth, value_and_grad
from .ops.linops import (
    DenseOperator,
    SparseOperator,
    DifferenceOperator,
    ScaledIdentity,
    StackedOperator,
    opnorm2,
)
from .solvers.rules import (
    Curvature,
    FixedStepsize,
    MalitskyMishchenkoRule,
    AdaPGMRule,
    AdaPGMPlusRule,
    OurRule,
    OurRulePlus,
)
from .solvers.common import Counters, Records, SolveResult
from .solvers.primal_dual import (
    adaptive_primal_dual,
    adaptive_proxgrad,
    fixed_proxgrad,
    condat_vu,
)
from .solvers.backtracking import backtracking_proxgrad, backtracking_nesterov
from .solvers.nesterov import fixed_nesterov
from .solvers.agraal import agraal
from .solvers.malitsky_pock import malitsky_pock
from .solvers.adapdm_plus import adaptive_linesearch_primal_dual
from .solvers.auto import auto_adaptive_proxgrad
from .ops.sparse import ELLOperator
from .ops.bcsr import BCSROperator

__version__ = "0.1.0"

__all__ = [
    # ops
    "Zero", "L1Norm", "L2Norm", "SqrL2Norm", "IndBox", "IndBall2", "IndZero",
    "ElasticNet", "GroupL2", "IndSimplex", "IndBall1", "LInfNorm", "Huber",
    "NuclearNorm", "IndPSD", "HingeLoss", "LogBarrier", "IndHalfspace",
    "IndHyperplane", "SeparableSum", "Scale", "Translate",
    "MoreauConjugate",
    "conjugate",
    "SmoothOracle", "FromFunction", "ZeroSmooth", "value_and_grad",
    "DenseOperator", "SparseOperator", "DifferenceOperator", "ScaledIdentity",
    "StackedOperator", "opnorm2",
    # rules
    "Curvature", "FixedStepsize", "MalitskyMishchenkoRule",
    "AdaPGMRule", "AdaPGMPlusRule", "OurRule", "OurRulePlus",
    # solvers
    "Counters", "Records", "SolveResult",
    "adaptive_primal_dual", "adaptive_proxgrad", "fixed_proxgrad", "condat_vu",
    "backtracking_proxgrad", "backtracking_nesterov", "fixed_nesterov",
    "agraal", "malitsky_pock", "adaptive_linesearch_primal_dual",
    "ELLOperator", "BCSROperator",
    "auto_adaptive_proxgrad",
]
