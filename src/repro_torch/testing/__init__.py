"""Test-support utilities (fault injection, torn-write helpers).

Shipped inside the package (not under ``tests/``) so the CI smoke jobs and
the pool workers — which import by module path, not test path — can reach
them; nothing here runs unless explicitly invoked.
"""
