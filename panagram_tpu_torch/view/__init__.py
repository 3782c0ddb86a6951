"""Pan-genome browser on the port's read API: a stdlib HTTP server that
renders matplotlib figures (panagram_tpu's viewer, on ``index.Table``s)."""
