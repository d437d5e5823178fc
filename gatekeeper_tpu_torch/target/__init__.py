from .handler import AugmentedReview, AugmentedUnstructured, K8sValidationTarget, WipeData
from .matcher import constraint_matches, needs_autoreject

__all__ = [
    "AugmentedReview",
    "AugmentedUnstructured",
    "K8sValidationTarget",
    "WipeData",
    "constraint_matches",
    "needs_autoreject",
]
