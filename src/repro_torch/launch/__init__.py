"""Launchers of the port (``repro.launch``'s counterpart): ``serve``, the
LLM serving command line; ``train``, the LLM training command line (the
unsharded step, or under ``torch.distributed.run`` the sharded one on the
host or production mesh), and ``steps``, its train steps
(``make_train_step``, ``make_sharded_train_step``); ``mesh``, the
``torch.distributed`` meshes and the rank launcher; ``shardings``, the
param, optimizer, batch, cache and activation layouts over a mesh;
``dryrun``, the production-mesh dry run on a fake rank group."""
