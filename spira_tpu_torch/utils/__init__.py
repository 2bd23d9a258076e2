"""Host-side helpers of the port: the render configuration
(:mod:`.config`), checkpoints (:mod:`.checkpoint`), progress and timing
(:mod:`.metrics`), profiling (:mod:`.profiling`) and the speed-of-light
model (:mod:`.sol`)."""
