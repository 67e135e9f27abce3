"""Label curation (``plumekit/label``): plume review and decisions, and
the model-ranked review order."""

from plumekit_torch.label.ranking import (load_plume_masks, load_prediction,
                                          plume_support, review_order)
from plumekit_torch.label.selector import (PlumeReview, apply_decisions,
                                           auto_reject, export_review_batch,
                                           find_plume_aod, interactive_review,
                                           order_reviews,
                                           remove_duplicated_plumes,
                                           review_plumes, subset_plume)

__all__ = [
    "remove_duplicated_plumes", "subset_plume", "find_plume_aod",
    "auto_reject", "review_plumes", "order_reviews", "apply_decisions",
    "export_review_batch", "interactive_review", "PlumeReview",
    "plume_support", "review_order", "load_prediction", "load_plume_masks",
]
