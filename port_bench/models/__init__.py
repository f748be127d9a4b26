"""Adapters from a configuration family to the program: each module
builds the port's model from a configuration and the seed, drives it
through the public entry points, and reads its counters and state."""
