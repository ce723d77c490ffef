"""Batched and multi-device execution: the mesh and the sharded steps,
the host streaming protocol (``runner``), row-sharded frame ops
(``spatial``) and the multi-device dry run (``dryrun``)."""
