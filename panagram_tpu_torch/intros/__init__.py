"""Introgression calling on the port's read API: the simulator, the caller,
the postprocessor, the scorer, the sweep plots and the runner of
panagram_tpu's ``intros`` command, driven by the same four-section YAML
config and group.tsv, on ``index.Table``s and numpy instead of pandas.
Heatmaps and plots need matplotlib, imported where they are drawn.
"""
