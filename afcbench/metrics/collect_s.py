"""Seconds of the collect an episode (``RolloutEngine.collect`` ->
``drl/rollout.rollout_batch`` -> ``CylinderEnv.env_step``, then the
postprocess): ``RolloutEngine.stats["collect_s"]`` under
``EngineConfig(timing=True)``, over the traced window's episodes."""


def read(rec):
    n = rec["stats"].get("episodes", 0)
    if not n or "collect_s" not in rec["stats"]:
        return None
    return rec["stats"]["collect_s"] / n
