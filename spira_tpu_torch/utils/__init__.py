"""Host-side helpers of the port (the speed-of-light model, :mod:`.sol`)."""
