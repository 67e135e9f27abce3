"""Figures and the campaign report (``plumekit/viz``): the annotated scene
and prediction PNGs behind ``--plot``, and ``report``'s markdown. Importing
this package loads no matplotlib; drawing imports it, and refuses with a
message where it is absent."""

from plumekit_torch.viz.plots import (matplotlib_present, plot_identify_bboxes,
                                      plot_identify_hulls, plot_prediction,
                                      plot_training_history)

__all__ = ["matplotlib_present", "plot_identify_bboxes", "plot_identify_hulls",
           "plot_prediction", "plot_training_history"]
