"""The configuration tree, shared with the JAX package.

`mvgformer_tpu.config` is framework-free (it imports only yaml and
dataclasses), so both packages read the same YAML experiment files and key
names. This is the one place the port imports it.
"""

from mvgformer_tpu.config import Config, load_config

__all__ = ["Config", "load_config"]
