"""The port's models: LunarisCoreVAE and LunarMoETeacher."""
