"""The multi-device training path (port of ``plagnn_tpu/parallel``, less
the TPU mesh planner): ``partition`` (destination blocks and halo tables),
``multihost`` (process-group bring-up), ``launch`` (local ranks in spawned
processes) and ``sharded`` (mesh, halo exchange, sharded layers, sharded
fold runner).  Nothing here is imported by the single-device path."""
