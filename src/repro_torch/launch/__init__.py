"""Launchers of the port (``repro.launch``'s counterpart): ``serve``, the
LLM serving command line.  Training, meshes and the dry-run wait for the
LLM training stack and multi-device work (ROADMAP §1 items 4c and 5)."""
