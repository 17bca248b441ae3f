"""Seconds of the PPO update an episode (``RolloutEngine._update`` ->
``drl/ppo.ppo_update``): ``RolloutEngine.stats["update_s"]`` under
``EngineConfig(timing=True)``, host clocks after the stream drains, over
the traced window's episodes."""


def read(rec):
    n = rec["stats"].get("episodes", 0)
    if not n or "update_s" not in rec["stats"]:
        return None
    return rec["stats"]["update_s"] / n
