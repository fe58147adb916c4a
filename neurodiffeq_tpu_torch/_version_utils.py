"""Deprecation helpers (counterpart of ``neurodiffeq_tpu/_version_utils.py``).

``warn_deprecate_class`` makes a class alias that warns with a
``FutureWarning`` on instantiation. ``deprecated_alias`` renames deprecated
keyword arguments to their new names with a ``FutureWarning``, and raises
``KeyError`` when both the old and the new name are passed.
"""
import functools
import warnings


def warn_deprecate_class(new_class):
    """A factory that warns with a ``FutureWarning`` and constructs ``new_class``."""

    @functools.wraps(new_class)
    def old_class_getter(*args, **kwargs):
        warnings.warn(f"This class name is deprecated, use {new_class} instead", FutureWarning)
        return new_class(*args, **kwargs)

    return old_class_getter


def deprecated_alias(**aliases):
    """Decorator renaming deprecated kwargs to their new names with a warning.

    Usage: ``@deprecated_alias(x='u')`` makes ``f(x=...)`` forward to ``f(u=...)``.
    """

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            _rename_kwargs(func.__name__, kwargs, aliases)
            return func(*args, **kwargs)

        return wrapper

    return decorator


def _rename_kwargs(func_name, kwargs, aliases):
    for old, new in aliases.items():
        if old in kwargs:
            if new in kwargs:
                raise KeyError(f"{func_name} received both `{old}` (deprecated) and `{new}` (recommended)")
            warnings.warn(f"The argument `{old}` is deprecated for {func_name}; use `{new}` instead.", FutureWarning)
            kwargs[new] = kwargs.pop(old)
