"""The multi-device training path (port of ``plagnn_tpu/parallel``):
``partition`` (destination blocks and halo tables), ``multihost``
(process-group bring-up), ``launch`` (local ranks in spawned processes),
``sharded`` (mesh, halo exchange, sharded layers, sharded fold runner) and
``planner`` (the (fold, graph) mesh for D cards, on measured H100 anchors).
Nothing here is imported by the single-device path."""
