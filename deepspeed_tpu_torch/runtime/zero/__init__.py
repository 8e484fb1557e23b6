"""ZeRO: the configuration schema, the partitioning rule and the tiled linear."""
