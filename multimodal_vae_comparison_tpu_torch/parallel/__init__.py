"""Multi-device training (counterpart of ``parallel/``): ``mesh`` (the
device mesh, batch and parameter placement), ``tensor_sharding`` (parameters
sharded over a model axis), ``launch`` (N ranks of a process group),
``rows`` (a rank's rows of a data-parallel batch) and ``dryrun`` (one
sharded train step of the flagship).
"""
