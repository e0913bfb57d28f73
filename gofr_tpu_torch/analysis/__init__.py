"""Runtime analysis of the port: the lock-discipline validator
(``lockcheck``)."""
