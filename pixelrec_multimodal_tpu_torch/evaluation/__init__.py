# pixelrec_multimodal_tpu_torch/evaluation/__init__.py
"""Evaluation layer: metric functions, retrieval and ranking evaluators,
novelty and diversity, advanced and fairness metrics (the names the JAX
package's ``evaluation`` exports)."""
from .advanced_metrics import AdvancedMetrics, FairnessMetrics  # noqa: F401
from .metrics import (  # noqa: F401
    calculate_map,
    calculate_ndcg,
    calculate_precision_at_k,
    calculate_recall_at_k,
)
from .novelty import DiversityCalculator, NoveltyMetrics  # noqa: F401
from .tasks import (  # noqa: F401
    EvaluationTask,
    TASK_MAPPING,
    TopKRankingEvaluator,
    TopKRetrievalEvaluator,
    create_evaluator,
    get_task_from_string,
)
