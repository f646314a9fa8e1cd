from flexam_tpu_torch.sampling.flow_match import (  # noqa: F401
    ScheduleTables,
    add_noise,
    build_schedule,
    make_sampler,
    sampler_init_state,
    sampler_step,
    schedule_arrays,
)
