"""Dataset entry points (``plumekit/data``)."""
