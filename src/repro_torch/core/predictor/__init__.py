from repro_torch.core.predictor.dataset import (
    eval_conv_ops, eval_linear_ops, sample_attn_ops, sample_conv_ops,
    sample_linear_ops, sample_ssm_ops, training_from_records)
from repro_torch.core.predictor.features import (
    blackbox_features, feature_names, kernel_of, whitebox_features)
from repro_torch.core.predictor.gbdt import GBDTParams, GBDTRegressor
from repro_torch.core.predictor.train import (LatencyPredictor, mape,
                                              measure_ops, train_predictor)

__all__ = [
    "eval_conv_ops", "eval_linear_ops", "sample_attn_ops", "sample_conv_ops",
    "sample_linear_ops", "sample_ssm_ops", "training_from_records",
    "blackbox_features", "feature_names", "kernel_of", "whitebox_features",
    "GBDTParams", "GBDTRegressor",
    "LatencyPredictor", "mape", "measure_ops", "train_predictor",
]
