"""Hyperparameter optimization: the native TPE engine with Optuna's
surface, and the study's PNG diagnostics (the names the JAX package's
``hpo`` exports)."""
from .search import (  # noqa: F401
    MedianPruner,
    RandomSampler,
    Study,
    TPESampler,
    Trial,
    TrialPruned,
    TrialState,
    create_study,
)
from .visualization import (  # noqa: F401
    compute_param_importances,
    plot_optimization_history,
    plot_parallel_coordinate,
    plot_param_importances,
    save_study_visualizations,
)
