"""Plans made executable: the ("data", "model") mesh of a plan's workers
(``launch.mesh``), and multi-process fleets: the bootstrap and heartbeats
(``launch.distributed``) and the elastic supervisor (``launch.fleet``);
and the language model's serving steps (``launch.steps``)."""
