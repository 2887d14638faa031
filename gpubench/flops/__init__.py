"""Model FLOPs of a configuration, from its layer shapes alone."""
