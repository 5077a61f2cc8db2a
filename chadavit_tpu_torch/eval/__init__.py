"""Offline evaluation: features, weighted kNN, linear and regression probes,
metrics (counterpart of ``chadavit_tpu/eval``)."""

from chadavit_tpu_torch.eval.features import extract_features, features_dim, make_feature_fn  # noqa: F401
from chadavit_tpu_torch.eval.knn import WeightedKNNClassifier, knn_classify  # noqa: F401
from chadavit_tpu_torch.eval.metrics import (  # noqa: F401
    accuracy_at_k,
    classification_suite,
    confusion_matrix,
    plot_confusion_matrix,
    regression_suite,
    weighted_mean,
)
from chadavit_tpu_torch.eval.probe import (  # noqa: F401
    MixupDraws,
    ProbeStepConfig,
    cross_entropy,
    layer_decay_scales,
    make_probe_eval_step,
    make_probe_train_step,
    mixup_cutmix,
    mixup_draws,
)
