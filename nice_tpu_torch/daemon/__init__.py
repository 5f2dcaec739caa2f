"""Idle-compute babysitter: runs the port's client when the machine is
otherwise idle."""
