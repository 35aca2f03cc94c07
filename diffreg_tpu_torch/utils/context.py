"""Scoped value registry: the reference's vision3d ContextManager.

Counterpart of the JAX package's utils/context.py (vision3d/engine/
context_manager.py:8-76): a process-global registry of named values
organized in scopes, which the reference uses to pass tensors between
decoupled modules without threading arguments. It stores any Python value or
tensor; the port's pipelines pass data explicitly, and the registry keeps the
API for code written against the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class ContextManager:
    def __init__(self):
        self._scopes: Dict[str, Dict[str, Any]] = {"default": {}}
        self._current = "default"

    # scope management ------------------------------------------------- #

    def create_scope(self, name: str) -> None:
        self._scopes.setdefault(name, {})

    def delete_scope(self, name: str) -> None:
        if name == "default":
            raise ValueError("cannot delete the default scope")
        self._scopes.pop(name, None)
        if self._current == name:
            self._current = "default"

    def set_scope(self, name: str) -> None:
        self.create_scope(name)
        self._current = name

    def get_scope(self) -> str:
        return self._current

    def scopes(self) -> Iterator[str]:
        return iter(self._scopes)

    # value registry --------------------------------------------------- #

    def register(self, key: str, value: Any, scope: Optional[str] = None) -> None:
        self._scopes[scope or self._current][key] = value

    def get(self, key: str, default: Any = None, scope: Optional[str] = None) -> Any:
        return self._scopes.get(scope or self._current, {}).get(key, default)

    def exists(self, key: str, scope: Optional[str] = None) -> bool:
        return key in self._scopes.get(scope or self._current, {})

    def remove(self, key: str, scope: Optional[str] = None) -> None:
        self._scopes.get(scope or self._current, {}).pop(key, None)

    def clear(self, scope: Optional[str] = None) -> None:
        self._scopes.get(scope or self._current, {}).clear()


_GLOBAL: Optional[ContextManager] = None


def get_context_manager() -> ContextManager:
    """Process-global instance (vision3d get_context_manager)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = ContextManager()
    return _GLOBAL
