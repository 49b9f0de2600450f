"""The yardstick's arithmetic: the H100's published peaks, the bytes and
operations of one kernel call from its shapes, and a configuration's
model FLOPs per token."""
