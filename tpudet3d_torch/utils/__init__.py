from .checkpoint import (latest_snapshot, load_converted, resolve_converted,
                         save_converted, snapshot_path)
from .convert import (jax_to_state_dict, load_jax_variables,
                      load_state_dict_strict)

__all__ = ['jax_to_state_dict', 'load_jax_variables', 'load_state_dict_strict',
           'latest_snapshot', 'load_converted', 'resolve_converted',
           'save_converted', 'snapshot_path']
