"""The loops that play traffic: one module a kind of traffic (the traffic
file's "loop")."""
