"""Runners of traffic mixes, named by a mix's `runner` key."""
