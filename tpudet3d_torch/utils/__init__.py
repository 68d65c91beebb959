from .convert import jax_to_state_dict, load_jax_variables

__all__ = ['jax_to_state_dict', 'load_jax_variables']
