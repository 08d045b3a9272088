"""Closed loop: each unit is sent when the one before it returns.

An arrival module gives ``due(traffic, seed, i)``: the seconds after the
window opens at which unit i is sent, or None to send it at once. A unit
sent late waits for the one before it, and its latency counts the wait."""


def due(traffic, seed, i):
    return None
