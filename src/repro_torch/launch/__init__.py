"""Launchers of the port (``repro.launch``'s counterpart): ``serve``, the
LLM serving command line; ``train``, the LLM training command line, and
``steps``, its train step; ``mesh``, the ``torch.distributed`` meshes and the
rank launcher; ``shardings``, the param, optimizer, batch, cache and
activation layouts over a mesh.  The sharded train step and the dry-run are
not ported yet (ROADMAP §1)."""
