"""Developer tooling for the analytics_zoo_tpu_torch codebase.

Submodules import lazily; the zoolint static analyzer itself is
pure-stdlib AST (only the runtime ``zoolint.sanitize`` half touches
torch, and only when entered).
"""
