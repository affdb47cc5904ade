"""The yardstick's arithmetic: peaks, each kernel's operations and bytes
at the shapes of a launch, and the model FLOPs of a sentence."""
