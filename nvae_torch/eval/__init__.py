"""Evaluation of the port (counterpart of ``nvae_tpu/eval``): the metric
suite (FID, k-NN precision/recall, PPL, the VGG16 / InceptionV3 /
random_conv feature backbones), the protocol that runs it and the IWAE
NLL."""

from nvae_torch.eval.evaluate import (  # noqa: F401
    EVAL_TEMPERATURES,
    Metric,
    Metrics,
    ModelEvaluation,
    evaluate_fid_against_dir,
    evaluate_model,
)
from nvae_torch.eval.features import extract_features, get_extractor  # noqa: F401
from nvae_torch.eval.frechet import (  # noqa: F401
    activation_statistics,
    fid_from_features,
    frechet_distance,
)
from nvae_torch.eval.nll import neg_log_likelihood  # noqa: F401
from nvae_torch.eval.precision_recall import (  # noqa: F401
    knn_precision_recall_features,
    pairwise_sq_dists,
)
