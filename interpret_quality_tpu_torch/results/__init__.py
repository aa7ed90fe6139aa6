"""Results tables (numpy and scipy).  The plots live in ``plots`` and
``visualization``, which need matplotlib and are imported on their own."""
from .tables import (
    cal_sensitivity,
    cal_sensitivity_all_pc,
    cal_mean_sv_intensity,
    cal_correlation_coef,
    cal_shapley_smoothness_metric_single_pc,
    cal_shapley_smoothness_metric,
)

__all__ = [
    "cal_sensitivity", "cal_sensitivity_all_pc", "cal_mean_sv_intensity",
    "cal_correlation_coef", "cal_shapley_smoothness_metric_single_pc",
    "cal_shapley_smoothness_metric",
]
