"""The configs of prepare_sim, AbacusHOD and the ZCV / LCV ``main``s: a dict
or a JSON file. (The JAX package reads YAML; a YAML config is converted to
JSON once, outside the port.)"""

import json

__all__ = ['load_config']


def load_config(config):
    """A config: a dict (copied) or the path of a JSON file holding one."""
    if isinstance(config, dict):
        return json.loads(json.dumps(config))
    with open(config) as f:
        return json.load(f)
