"""Host data layer: config-driven datasets, the DataModule and native batching."""
