// Native star-rating calculator (replaces the reference's rosu-pp dependency,
// reference: osuT5/osuT5/dataset/data_utils.py:195-226, calc_fid.py:149-163).
//
// Implements the classic (2014-2019 live) osu! strain-based difficulty
// algorithms for all four gamemodes. These are the long-published "ppv2"
// formulas: per-object strain with exponential decay, 400 ms section peaks,
// and a 0.9-weighted peak sum. They track current lazer ratings closely on
// typical maps but are not bit-identical to present-day rosu-pp.
//
// Exposed as a C ABI for ctypes; geometry (slider curves, stacking) is
// resolved on the Python side, which passes flat arrays.
//
// Build: make -C native   (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kSectionLength = 400.0;  // ms per strain section
constexpr double kDecayWeight = 0.9;      // weight ratio of sorted peaks

// Weighted sum of sorted section peaks.
double weighted_peaks(std::vector<double>& peaks) {
    std::sort(peaks.begin(), peaks.end(), std::greater<double>());
    double difficulty = 0.0, weight = 1.0;
    for (double p : peaks) {
        difficulty += p * weight;
        weight *= kDecayWeight;
    }
    return difficulty;
}

// Generic strain-peak accumulator: times in ms (already clock-rate scaled),
// strains[i] is the running strain value at object i.
double peak_difficulty(const std::vector<double>& times, const std::vector<double>& strains,
                       double decay_base, double section_length = kSectionLength) {
    if (times.empty()) return 0.0;
    std::vector<double> peaks;
    double section_end = std::ceil(times[0] / section_length) * section_length;
    double current_peak = 0.0;
    for (size_t i = 0; i < times.size(); ++i) {
        while (times[i] > section_end) {
            peaks.push_back(current_peak);
            // carry the previous object's strain, decayed to the section start
            double gap = section_end - times[i ? i - 1 : 0];
            current_peak = i == 0 ? 0.0 : strains[i - 1] * std::pow(decay_base, gap / 1000.0);
            section_end += section_length;
        }
        current_peak = std::max(current_peak, strains[i]);
    }
    peaks.push_back(current_peak);
    return weighted_peaks(peaks);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// osu!standard — aim + speed skills.
//   types: 0=circle, 1=slider, 2=spinner (spinners sit at playfield centre)
// ---------------------------------------------------------------------------
double osu_std_stars(const double* times, const double* xs, const double* ys,
                     const int32_t* types, int32_t n, double cs, double clock_rate) {
    if (n < 2) return 0.0;
    (void)types;

    // circle radius in osu!pixels and distance normalization
    double radius = 32.0 * (1.0 - 0.7 * (cs - 5.0) / 5.0);
    double scaling = 52.0 / radius;
    if (radius < 30.0) scaling *= 1.0 + std::min(30.0 - radius, 5.0) / 50.0;

    constexpr double kDecayBase[2] = {0.3, 0.15};      // speed, aim
    constexpr double kWeightScaling[2] = {1400.0, 26.25};
    constexpr double kAlmostDiameter = 90.0;
    constexpr double kStreamSpacing = 110.0;
    constexpr double kSingleSpacing = 125.0;

    std::vector<double> t(n);
    for (int32_t i = 0; i < n; ++i) t[i] = times[i] / clock_rate;

    double stars[2];
    for (int skill = 0; skill < 2; ++skill) {
        std::vector<double> strains(n, 1.0);
        double strain = 1.0;
        for (int32_t i = 1; i < n; ++i) {
            double dt = t[i] - t[i - 1];
            double decay = std::pow(kDecayBase[skill], dt / 1000.0);
            double dx = (xs[i] - xs[i - 1]) * scaling;
            double dy = (ys[i] - ys[i - 1]) * scaling;
            double d = std::sqrt(dx * dx + dy * dy);

            double addition;
            if (skill == 0) {  // speed: spacing weight
                if (d > kSingleSpacing) {
                    addition = 2.5;
                } else if (d > kStreamSpacing) {
                    addition = 1.6 + 0.9 * (d - kStreamSpacing) / (kSingleSpacing - kStreamSpacing);
                } else if (d > kAlmostDiameter) {
                    addition = 1.2 + 0.4 * (d - kAlmostDiameter) / (kStreamSpacing - kAlmostDiameter);
                } else if (d > kAlmostDiameter / 2.0) {
                    addition = 0.95 + 0.25 * (d - kAlmostDiameter / 2.0) / (kAlmostDiameter / 2.0);
                } else {
                    addition = 0.95;
                }
            } else {  // aim
                addition = std::pow(d, 0.99);
            }
            strain = strain * decay + addition * kWeightScaling[skill] / std::max(dt, 50.0);
            strains[i] = strain;
        }
        stars[skill] = std::sqrt(peak_difficulty(t, strains, kDecayBase[skill])) * 0.0675;
    }
    return stars[0] + stars[1] + std::abs(stars[0] - stars[1]) * 0.5;
}

// ---------------------------------------------------------------------------
// taiko — colour-change + rhythm-change strain.
//   colors: 0=don (red), 1=kat (blue), other values = drumroll/denden (no
//   colour contribution)
// ---------------------------------------------------------------------------
double taiko_stars(const double* times, const int32_t* colors, int32_t n, double clock_rate) {
    if (n < 2) return 0.0;
    constexpr double kDecayBase = 0.30;
    constexpr double kRhythmChangeBase = 2.0;
    constexpr double kRhythmChangeBaseThreshold = 0.2;

    std::vector<double> t(n);
    for (int32_t i = 0; i < n; ++i) t[i] = times[i] / clock_rate;

    std::vector<double> strains(n, 1.0);
    double strain = 1.0;
    double prev_dt = -1.0;
    int same_color_count = 1;
    for (int32_t i = 1; i < n; ++i) {
        double dt = t[i] - t[i - 1];
        double decay = std::pow(kDecayBase, dt / 1000.0);

        double addition = 1.0;
        bool is_hit = colors[i] <= 1 && colors[i - 1] <= 1;
        if (is_hit && dt < 1000.0) {
            // colour change: counts runs of a colour; parity-gated bonus
            if (colors[i] != colors[i - 1]) {
                addition += (same_color_count % 2 == 0) ? 0.75 : 0.0;
                same_color_count = 1;
            } else {
                ++same_color_count;
            }
            // rhythm change: gap ratio moved by more than the threshold
            if (prev_dt > 0.0 && dt > 0.0) {
                double ratio = dt > prev_dt ? dt / prev_dt : prev_dt / dt;
                if (std::abs(ratio - std::round(ratio)) > kRhythmChangeBaseThreshold &&
                    ratio < kRhythmChangeBase * 8.0) {
                    addition += 1.0;
                }
            }
        }
        double addition_factor = dt < 50.0 ? 0.4 + 0.6 * dt / 50.0 : 1.0;
        strain = strain * decay + addition * addition_factor;
        strains[i] = strain;
        prev_dt = dt;
    }
    return std::sqrt(peak_difficulty(t, strains, kDecayBase)) * 0.04125;
}

// ---------------------------------------------------------------------------
// mania — per-column individual strain + overall strain with hold-note
// overlap bonuses.
// ---------------------------------------------------------------------------
double mania_stars(const double* times, const double* end_times, const int32_t* columns,
                   int32_t n, int32_t keys, double clock_rate) {
    if (n < 2 || keys < 1) return 0.0;
    constexpr double kIndividualDecayBase = 0.125;
    constexpr double kOverallDecayBase = 0.30;

    std::vector<double> t(n), et(n);
    for (int32_t i = 0; i < n; ++i) {
        t[i] = times[i] / clock_rate;
        et[i] = std::max(end_times[i], times[i]) / clock_rate;
    }

    std::vector<double> individual(keys, 0.0);
    std::vector<double> held_until(keys, 0.0);
    std::vector<double> strains(n, 1.0);
    double overall = 1.0;
    for (int32_t i = 1; i < n; ++i) {
        double dt = t[i] - t[i - 1];
        int32_t col = std::clamp(columns[i], 0, keys - 1);

        double hold_factor = 1.0, hold_addition = 0.0;
        for (int32_t k = 0; k < keys; ++k) {
            if (held_until[k] > et[i] + 1.0) hold_factor = 1.25;       // spans past this note
            else if (held_until[k] > t[i] + 1.0) hold_addition = 1.0;  // releases during it
        }

        for (int32_t k = 0; k < keys; ++k)
            individual[k] *= std::pow(kIndividualDecayBase, dt / 1000.0);
        overall = overall * std::pow(kOverallDecayBase, dt / 1000.0) + (1.0 + hold_addition) * hold_factor;
        individual[col] += 2.0 * hold_factor;

        held_until[col] = et[i];
        strains[i] = individual[col] + overall;
    }
    return peak_difficulty(t, strains, kOverallDecayBase) * 0.018;
}

// ---------------------------------------------------------------------------
// catch — horizontal movement strain with direction-change bonus.
// ---------------------------------------------------------------------------
double catch_stars(const double* times, const double* xs, int32_t n, double cs, double clock_rate) {
    if (n < 2) return 0.0;
    constexpr double kDecayBase = 0.20;
    constexpr double kStrainStep = 750.0;
    constexpr double kPeaksDecayWeight = 0.94;
    constexpr double kPositionError = 16.0;           // absolute player positioning error
    constexpr double kNormalizedRadius = 41.0;
    constexpr double kDirectionChangeBonus = 12.5;

    double catcher_width = 305.0 * (1.0 - 0.7 * (cs - 5.0) / 5.0) / 2.0;
    double scaling = kNormalizedRadius / (catcher_width * 0.4);

    std::vector<double> t(n);
    for (int32_t i = 0; i < n; ++i) t[i] = times[i] / clock_rate;

    std::vector<double> strains(n, 1.0);
    double strain = 1.0;
    double last_dir = 0.0;
    double player_x = xs[0] * scaling;
    for (int32_t i = 1; i < n; ++i) {
        double dt = std::max(t[i] - t[i - 1], 25.0);
        double decay = std::pow(kDecayBase, dt / 1000.0);

        double target = xs[i] * scaling;
        double dist = std::abs(target - player_x);
        double dir = target > player_x ? 1.0 : (target < player_x ? -1.0 : 0.0);

        double addition = std::pow(std::max(dist - kPositionError * scaling, 0.0), 1.3) / 500.0;
        if (dir != 0.0 && dir != last_dir && last_dir != 0.0) {
            addition += kDirectionChangeBonus / std::max(dt, 25.0) * std::min(dist / 100.0, 1.0);
        }
        strain = strain * decay + addition * 850.0 / std::max(dt, 25.0);
        strains[i] = strain;
        player_x = target;
        if (dir != 0.0) last_dir = dir;
    }

    // catch uses 750 ms sections and 0.94 peak weighting
    std::vector<double> peaks;
    double section_end = std::ceil(t[0] / kStrainStep) * kStrainStep;
    double current_peak = 0.0;
    for (int32_t i = 0; i < n; ++i) {
        while (t[i] > section_end) {
            peaks.push_back(current_peak);
            double gap = section_end - t[i ? i - 1 : 0];
            current_peak = i == 0 ? 0.0 : strains[i - 1] * std::pow(kDecayBase, gap / 1000.0);
            section_end += kStrainStep;
        }
        current_peak = std::max(current_peak, strains[i]);
    }
    peaks.push_back(current_peak);
    std::sort(peaks.begin(), peaks.end(), std::greater<double>());
    double difficulty = 0.0, weight = 1.0;
    for (double p : peaks) {
        difficulty += p * weight;
        weight *= kPeaksDecayWeight;
    }
    return std::sqrt(difficulty) * 0.145;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// osu!standard — CURRENT (lazer 2022+/rosu-pp 3.x) algorithm.
//
// Ports the modern evaluator structure: DifficultyHitObject preprocessing
// (lazy jump / minimum jump / angles, slider travel), the Aim evaluator
// (wide/acute angle bonuses, velocity-change and slider bonuses, with and
// without sliders), the Speed evaluator with the island-based Rhythm
// multiplier, OsuStrainSkill peak reduction, and the 2-skill star-rating
// combination. The Python wrapper resolves slider geometry (lazy travel via
// the follow-circle cursor simulation) and stacking, and passes flat arrays.
//
// Not bit-verified against rosu-pp (no network in this environment; see
// tests/test_difficulty.py for the structural/monotonicity suite) but
// implements the same published algorithm rather than 2014 ppv2.
// ---------------------------------------------------------------------------

namespace modern {

constexpr double kPi = 3.14159265358979323846;
constexpr double kNormalisedRadius = 50.0;
constexpr double kMaximumSliderRadius = kNormalisedRadius * 2.4;
constexpr double kAssumedSliderRadius = kNormalisedRadius * 1.8;
constexpr double kMinDeltaTime = 25.0;

struct HitObject {
    double time;          // clock-adjusted ms
    double x, y;          // stacked position
    int type;             // 0 circle, 1 slider, 2 spinner
    // slider-only fields (normalized units / adjusted ms)
    double lazy_end_x, lazy_end_y;
    double travel_dist;       // normalized lazy travel distance
    double travel_time;       // adjusted ms (>= kMinDeltaTime)
    double tail_x, tail_y;    // stacked tail position
};

struct DiffObject {
    double strain_time = 0.0;       // delta clamped to >= 25ms
    double delta_time = 0.0;
    double lazy_jump = 0.0;         // normalized
    double min_jump = 0.0;          // normalized
    double min_jump_time = 0.0;
    double travel_dist = 0.0;       // of THIS object when it is a slider
    double travel_time = kMinDeltaTime;
    double angle = -1.0;            // <0 == undefined
    bool is_slider = false;
    bool is_spinner = false;
};

inline double length(double dx, double dy) { return std::sqrt(dx * dx + dy * dy); }

// cursor position the player is assumed to leave an object at
inline void end_cursor(const HitObject& h, double* cx, double* cy) {
    if (h.type == 1) { *cx = h.lazy_end_x; *cy = h.lazy_end_y; }
    else { *cx = h.x; *cy = h.y; }
}

std::vector<DiffObject> preprocess(const std::vector<HitObject>& objs, double scaling) {
    std::vector<DiffObject> out(objs.size());
    for (size_t i = 1; i < objs.size(); ++i) {
        const HitObject& curr = objs[i];
        const HitObject& last = objs[i - 1];
        DiffObject& d = out[i];
        d.delta_time = curr.time - last.time;
        d.strain_time = std::max(d.delta_time, kMinDeltaTime);
        d.is_slider = curr.type == 1;
        d.is_spinner = curr.type == 2;
        d.travel_dist = curr.type == 1 ? curr.travel_dist : 0.0;
        d.travel_time = curr.type == 1 ? std::max(curr.travel_time, kMinDeltaTime) : kMinDeltaTime;

        if (curr.type == 2 || last.type == 2) continue;  // spinners carry no distances

        double lcx, lcy;
        end_cursor(last, &lcx, &lcy);
        d.lazy_jump = length(curr.x - lcx, curr.y - lcy) * scaling;
        d.min_jump = d.lazy_jump;
        d.min_jump_time = d.strain_time;

        if (last.type == 1) {
            double last_travel = std::max(last.travel_time, kMinDeltaTime);
            d.min_jump_time = std::max(d.strain_time - last_travel, kMinDeltaTime);
            double tail_jump = length(last.tail_x - curr.x, last.tail_y - curr.y) * scaling;
            d.min_jump = std::max(
                0.0, std::min(d.lazy_jump - (kMaximumSliderRadius - kAssumedSliderRadius),
                              tail_jump - kMaximumSliderRadius));
        }

        if (i >= 2) {
            const HitObject& last_last = objs[i - 2];
            if (last_last.type != 2) {
                double llcx, llcy;
                end_cursor(last_last, &llcx, &llcy);
                double v1x = llcx - last.x, v1y = llcy - last.y;
                double v2x = curr.x - lcx, v2y = curr.y - lcy;
                double dot = v1x * v2x + v1y * v2y;
                double det = v1x * v2y - v1y * v2x;
                if (length(v1x, v1y) > 1e-9 && length(v2x, v2y) > 1e-9)
                    d.angle = std::abs(std::atan2(det, dot));
            }
        }
    }
    return out;
}

inline double calc_wide_angle_bonus(double angle) {
    double a = std::min(5.0 / 6.0 * kPi, std::max(kPi / 6.0, angle));
    double s = std::sin(3.0 / 4.0 * (a - kPi / 6.0));
    return s * s;
}

inline double calc_acute_angle_bonus(double angle) { return 1.0 - calc_wide_angle_bonus(angle); }

// AimEvaluator (osu.Game.Rulesets.Osu.Difficulty.Evaluators.AimEvaluator)
double aim_value(const std::vector<DiffObject>& d, size_t i, bool with_sliders) {
    constexpr double wide_angle_multiplier = 1.5;
    constexpr double acute_angle_multiplier = 1.95;
    constexpr double slider_multiplier = 1.35;
    constexpr double velocity_change_multiplier = 0.75;

    if (i < 2) return 0.0;
    const DiffObject& curr = d[i];
    const DiffObject& last = d[i - 1];
    if (curr.is_spinner || last.is_spinner) return 0.0;

    double curr_velocity = curr.lazy_jump / curr.strain_time;
    if (last.is_slider && with_sliders) {
        double travel_velocity = last.travel_dist / last.travel_time;
        double movement_velocity = curr.min_jump / curr.min_jump_time;
        curr_velocity = std::max(curr_velocity, movement_velocity + travel_velocity);
    }

    double prev_velocity = last.lazy_jump / last.strain_time;
    if (i >= 2 && d[i - 2].is_slider && with_sliders) {
        double travel_velocity = d[i - 2].travel_dist / d[i - 2].travel_time;
        double movement_velocity = last.min_jump / last.min_jump_time;
        prev_velocity = std::max(prev_velocity, movement_velocity + travel_velocity);
    }

    double wide_angle_bonus = 0.0, acute_angle_bonus = 0.0;
    double slider_bonus = 0.0, velocity_change_bonus = 0.0;
    double aim_strain = curr_velocity;

    if (std::max(curr.strain_time, last.strain_time) <
        1.25 * std::min(curr.strain_time, last.strain_time)) {
        if (curr.angle >= 0.0 && last.angle >= 0.0 && i >= 2 && d[i - 2].angle >= 0.0) {
            double angle_bonus = std::min(curr_velocity, prev_velocity);
            wide_angle_bonus = calc_wide_angle_bonus(curr.angle);
            acute_angle_bonus = calc_acute_angle_bonus(curr.angle);
            if (curr.strain_time > 100.0) {
                acute_angle_bonus = 0.0;
            } else {
                double s1 = std::sin(kPi / 2.0 * std::min(1.0, (100.0 - curr.strain_time) / 25.0));
                double jump = std::clamp(curr.lazy_jump, 50.0, 100.0);
                double s2 = std::sin(kPi / 2.0 * (jump - 50.0) / 50.0);
                acute_angle_bonus *= calc_acute_angle_bonus(last.angle) *
                                     std::min(angle_bonus, 125.0 / curr.strain_time) *
                                     s1 * s1 * s2 * s2;
            }
            double last_wide = calc_wide_angle_bonus(last.angle);
            wide_angle_bonus *= angle_bonus *
                (1.0 - std::min(wide_angle_bonus, last_wide * last_wide * last_wide));
            double ll_acute = calc_acute_angle_bonus(d[i - 2].angle);
            acute_angle_bonus *= 0.5 + 0.5 *
                (1.0 - std::min(acute_angle_bonus, ll_acute * ll_acute * ll_acute));
        }
    }

    if (std::max(prev_velocity, curr_velocity) > 0.0) {
        double pv = (last.lazy_jump + (i >= 2 ? d[i - 2].travel_dist : 0.0)) / last.strain_time;
        double cv = (curr.lazy_jump + last.travel_dist) / curr.strain_time;
        double s = std::sin(kPi / 2.0 * std::abs(pv - cv) / std::max(pv, std::max(cv, 1e-9)));
        double dist_ratio = s * s;
        double overlap_velocity_buff =
            std::min(125.0 / std::min(curr.strain_time, last.strain_time), std::abs(pv - cv));
        double t_ratio = std::min(curr.strain_time, last.strain_time) /
                         std::max(curr.strain_time, last.strain_time);
        velocity_change_bonus = overlap_velocity_buff * dist_ratio * t_ratio * t_ratio;
    }

    if (last.is_slider) slider_bonus = last.travel_dist / last.travel_time;

    aim_strain += std::max(acute_angle_bonus * acute_angle_multiplier,
                           wide_angle_bonus * wide_angle_multiplier +
                               velocity_change_bonus * velocity_change_multiplier);
    if (with_sliders) aim_strain += slider_bonus * slider_multiplier;
    return aim_strain;
}

// RhythmEvaluator: island-based rhythm complexity over a 5 s history
double rhythm_value(const std::vector<DiffObject>& d, size_t i, double great_window) {
    constexpr double history_time_max = 5000.0;
    constexpr double rhythm_multiplier = 0.75;

    if (d[i].is_spinner) return 1.0;

    double rhythm_complexity_sum = 0.0;
    int island_size = 1, previous_island_size = 0;
    double start_ratio = 0.0;
    bool first_delta_switch = false;

    int historical_note_count = std::min<int>(static_cast<int>(i), 32);
    int rhythm_start = 0;
    // accumulate object start times backwards
    std::vector<double> rel_start(historical_note_count + 2, 0.0);
    for (int b = 1; b <= historical_note_count + 1 && static_cast<int>(i) - b >= 0; ++b)
        rel_start[b] = rel_start[b - 1] + d[i - b + 1].delta_time;

    while (rhythm_start < historical_note_count - 2 &&
           rel_start[rhythm_start + 1] < history_time_max)
        ++rhythm_start;

    for (int j = rhythm_start; j > 0; --j) {
        const DiffObject& curr_obj = d[i - j + 1];
        const DiffObject& prev_obj = d[i - j];
        const DiffObject& last_obj = (static_cast<int>(i) - j - 1) >= 0 ? d[i - j - 1] : d[i - j];

        double curr_historical_decay =
            (history_time_max - rel_start[j - 1 >= 0 ? j - 1 : 0]) / history_time_max;
        if (curr_historical_decay <= 0.0) continue;
        curr_historical_decay = std::min(
            static_cast<double>(historical_note_count - j) / historical_note_count,
            curr_historical_decay);

        double curr_delta = curr_obj.strain_time;
        double prev_delta = prev_obj.strain_time;
        double last_delta = last_obj.strain_time;
        double ratio_arg = kPi / (std::min(prev_delta, curr_delta) / std::max(prev_delta, curr_delta));
        double s = std::sin(ratio_arg);
        double curr_ratio = 1.0 + 6.0 * std::min(0.5, s * s);

        double window_penalty = std::min(
            1.0, std::max(0.0, std::abs(prev_delta - curr_delta) - great_window * 0.3) /
                     (great_window * 0.3));
        double effective_ratio = window_penalty * curr_ratio;

        if (first_delta_switch) {
            if (!(prev_delta > 1.25 * curr_delta || prev_delta * 1.25 < curr_delta)) {
                if (island_size < 7) ++island_size;
            } else {
                if (curr_obj.is_slider) effective_ratio *= 0.125;
                if (prev_obj.is_slider) effective_ratio *= 0.25;
                if (previous_island_size == island_size) effective_ratio *= 0.25;
                if (previous_island_size % 2 == island_size % 2) effective_ratio *= 0.50;
                if (last_delta > prev_delta + 10.0 && prev_delta > curr_delta + 10.0)
                    effective_ratio *= 0.125;

                rhythm_complexity_sum += std::sqrt(effective_ratio * start_ratio) *
                                         curr_historical_decay *
                                         std::sqrt(4.0 + island_size) / 2.0 *
                                         std::sqrt(4.0 + previous_island_size) / 2.0;
                start_ratio = effective_ratio;
                previous_island_size = island_size;
                if (prev_delta * 1.25 < curr_delta) first_delta_switch = false;
                island_size = 1;
            }
        } else if (prev_delta > 1.25 * curr_delta) {
            first_delta_switch = true;
            start_ratio = effective_ratio;
            island_size = 1;
        }
    }
    return std::sqrt(4.0 + rhythm_complexity_sum * rhythm_multiplier) / 2.0;
}

// SpeedEvaluator
double speed_value(const std::vector<DiffObject>& d, size_t i, double great_window) {
    constexpr double single_spacing_threshold = 125.0;
    constexpr double min_speed_bonus = 75.0;
    constexpr double speed_balancing_factor = 40.0;

    if (d[i].is_spinner) return 0.0;

    double strain_time = d[i].strain_time;

    // doubletapness against the NEXT object (lazer GetDoubletapness)
    double doubletapness = 1.0;
    if (i + 1 < d.size() && !d[i + 1].is_spinner) {
        double curr_delta = std::max(1.0, d[i].delta_time);
        double next_delta = std::max(1.0, d[i + 1].delta_time);
        double delta_diff = std::abs(next_delta - curr_delta);
        double speed_ratio = curr_delta / std::max(curr_delta, delta_diff);
        double window_ratio = std::pow(std::min(1.0, curr_delta / great_window), 2.0);
        doubletapness = std::pow(speed_ratio, 1.0 - window_ratio);
    }

    double speed_bonus = 1.0;
    if (strain_time < min_speed_bonus) {
        double r = (min_speed_bonus - strain_time) / speed_balancing_factor;
        speed_bonus = 1.0 + 0.75 * r * r;
    }

    double travel = i >= 1 ? d[i - 1].travel_dist : 0.0;
    double dist = std::min(single_spacing_threshold, travel + d[i].min_jump);

    return (speed_bonus + speed_bonus * std::pow(dist / single_spacing_threshold, 3.5)) *
           doubletapness / strain_time;
}

// StrainSkill section peaks + OsuStrainSkill reduced-section difficulty value
double strain_skill_difficulty(const std::vector<double>& times,
                               const std::vector<double>& strains,
                               double decay_base, int reduced_section_count,
                               double difficulty_multiplier) {
    constexpr double section_length = 400.0;
    if (times.empty()) return 0.0;
    std::vector<double> peaks;
    double section_end = std::ceil(times[0] / section_length) * section_length;
    double current_peak = 0.0;
    for (size_t i = 0; i < times.size(); ++i) {
        while (times[i] > section_end) {
            if (current_peak > 0.0) peaks.push_back(current_peak);
            double gap = section_end - times[i ? i - 1 : 0];
            current_peak = i == 0 ? 0.0 : strains[i - 1] * std::pow(decay_base, gap / 1000.0);
            section_end += section_length;
        }
        current_peak = std::max(current_peak, strains[i]);
    }
    if (current_peak > 0.0) peaks.push_back(current_peak);

    std::sort(peaks.begin(), peaks.end(), std::greater<double>());
    int n_reduce = std::min<int>(peaks.size(), reduced_section_count);
    for (int i = 0; i < n_reduce; ++i) {
        double t = std::clamp(static_cast<double>(i) / reduced_section_count, 0.0, 1.0);
        double scale = std::log10(1.0 + t * 9.0);  // lerp(1, 10, t) in log10
        peaks[i] *= 0.75 + (1.0 - 0.75) * scale;   // lerp(ReducedStrainBaseline, 1, scale)
    }
    std::sort(peaks.begin(), peaks.end(), std::greater<double>());

    double difficulty = 0.0, weight = 1.0;
    for (double p : peaks) {
        difficulty += p * weight;
        weight *= 0.9;
    }
    return difficulty * difficulty_multiplier;
}

}  // namespace modern

extern "C" {

// Current-algorithm osu!std star rating.
//   times: raw ms (NOT clock-scaled; scaling happens here)
//   xs/ys: stacked positions; types: 0 circle / 1 slider / 2 spinner
//   lazy_end_x/y, travel_dist (normalized), travel_time (raw ms),
//   tail_x/y: slider fields (ignored for non-sliders)
//   radius: object radius in osu!px; od: overall difficulty; clock_rate
double osu_std_stars_v2(const double* times, const double* xs, const double* ys,
                        const int32_t* types,
                        const double* lazy_end_x, const double* lazy_end_y,
                        const double* travel_dist, const double* travel_time,
                        const double* tail_x, const double* tail_y,
                        int32_t n, double radius, double od, double clock_rate) {
    using namespace modern;
    if (n < 2) return 0.0;

    double scaling = kNormalisedRadius / radius;
    if (radius < 30.0) scaling *= 1.0 + std::min(30.0 - radius, 5.0) / 50.0;

    std::vector<HitObject> objs(n);
    for (int32_t i = 0; i < n; ++i) {
        objs[i] = {times[i] / clock_rate, xs[i], ys[i], types[i],
                   lazy_end_x[i], lazy_end_y[i],
                   travel_dist[i], travel_time[i] / clock_rate,
                   tail_x[i], tail_y[i]};
    }
    std::vector<DiffObject> d = preprocess(objs, scaling);

    double great_window = (80.0 - 6.0 * od) / clock_rate;
    std::vector<double> t(n);
    for (int32_t i = 0; i < n; ++i) t[i] = objs[i].time;

    // skills: aim (with sliders) + speed (with the rhythm multiplier).
    // (The no-sliders aim pass only feeds lazer's SliderFactor pp attribute,
    // which the star rating does not use — deliberately not computed.)
    constexpr double aim_skill_multiplier = 23.55;
    constexpr double aim_decay = 0.15;
    constexpr double speed_skill_multiplier = 1375.0;
    constexpr double speed_decay = 0.3;

    std::vector<double> aim_strains(n, 0.0), speed_strains(n, 0.0);
    double aim_strain = 0.0, speed_strain = 0.0;
    for (int32_t i = 1; i < n; ++i) {
        double dt = d[i].delta_time;
        aim_strain = aim_strain * std::pow(aim_decay, dt / 1000.0) +
                     aim_value(d, i, true) * aim_skill_multiplier;
        double rhythm = rhythm_value(d, i, great_window);
        speed_strain = speed_strain * std::pow(speed_decay, dt / 1000.0) +
                       speed_value(d, i, great_window) * speed_skill_multiplier;
        aim_strains[i] = aim_strain;
        speed_strains[i] = speed_strain * rhythm;
    }

    double aim_difficulty = strain_skill_difficulty(t, aim_strains, aim_decay, 10, 1.06);
    double speed_difficulty = strain_skill_difficulty(t, speed_strains, speed_decay, 5, 1.04);

    double aim_rating = std::sqrt(aim_difficulty) * 0.0675;
    double speed_rating = std::sqrt(speed_difficulty) * 0.0675;

    double base_aim = std::pow(5.0 * std::max(1.0, aim_rating / 0.0675) - 4.0, 3.0) / 100000.0;
    double base_speed = std::pow(5.0 * std::max(1.0, speed_rating / 0.0675) - 4.0, 3.0) / 100000.0;
    double base_perf = std::pow(std::pow(base_aim, 1.1) + std::pow(base_speed, 1.1), 1.0 / 1.1);

    if (base_perf <= 0.00001) return 0.0;
    constexpr double performance_base_multiplier = 1.15;
    return std::cbrt(performance_base_multiplier) * 0.027 *
           (std::cbrt(100000.0 / std::pow(2.0, 1.0 / 1.1) * base_perf) + 4.0);
}

}  // extern "C"

// ===========================================================================
// Current-generation (lazer 2022+ era, the algorithms rosu-pp 3.x ships)
// difficulty for the other three rulesets. Structure and constants follow
// the published open-source implementations:
//   taiko — the 2022 colour/rhythm/stamina rework with the Peaks norm
//           combination and the log rescale
//           (osu.Game.Rulesets.Taiko.Difficulty)
//   catch — the Movement skill with direction-change/edge-dash bonuses and
//           the hyper-dash pre-pass (osu.Game.Rulesets.Catch.Difficulty)
//   mania — the per-column/overall Strain with hold-overlap additions
//           (osu.Game.Rulesets.Mania.Difficulty)
// Bit-parity against rosu-pp is not verifiable in this offline environment;
// golden snapshot tests in tests/test_difficulty.py lock these
// implementations against silent drift (see STATUS.md).
// ===========================================================================

namespace modern_common {

// lazer StrainSkill section machinery: 400 ms (default) sections whose peak
// is the max running strain; a section opens with the previous strain
// decayed to the boundary.
struct SectionPeaks {
    double section_length;
    std::vector<double> peaks;
    double current_peak = 0.0;
    double section_end = 0.0;
    bool first = true;

    explicit SectionPeaks(double len = 400.0) : section_length(len) {}

    // initial_at(gap_ms) -> the strain carried into a section that opens
    // gap_ms after the previous object (lazer CalculateInitialStrain)
    template <typename InitialFn>
    void step_with(double time, double prev_time, double strain_after, InitialFn initial_at) {
        if (first) {
            section_end = std::ceil(time / section_length) * section_length;
            first = false;
        }
        while (time > section_end) {
            peaks.push_back(current_peak);
            current_peak = initial_at(section_end - prev_time);
            section_end += section_length;
        }
        current_peak = std::max(current_peak, strain_after);
    }

    void step(double time, double prev_time, double strain_after,
              double initial_strain_at_boundary_base, double decay_base) {
        step_with(time, prev_time, strain_after, [&](double gap) {
            return initial_strain_at_boundary_base * std::pow(decay_base, gap / 1000.0);
        });
    }

    std::vector<double> collect() const {
        auto p = peaks;
        p.push_back(current_peak);
        return p;
    }
};

double weighted_sum(std::vector<double> peaks, double decay_weight) {
    std::sort(peaks.begin(), peaks.end(), std::greater<double>());
    double difficulty = 0.0, weight = 1.0;
    for (double p : peaks) {
        difficulty += p * weight;
        weight *= decay_weight;
    }
    return difficulty;
}

double norm(double p, double a, double b) {
    return std::pow(std::pow(a, p) + std::pow(b, p), 1.0 / p);
}

}  // namespace modern_common

// ---------------------------------------------------------------------------
// taiko (2022 rework)
// ---------------------------------------------------------------------------

namespace modern_taiko {

constexpr int kMaxRepetitionInterval = 16;

struct Note {
    double time;      // clock-scaled ms
    int colour;       // 0 don, 1 kat, >=2 non-hit (drumroll/denden)
    bool is_hit() const { return colour == 0 || colour == 1; }
};

// colour-encoding structures (ColourDifficultyPreprocessor)
struct MonoStreak {
    int first = -1, length = 0, colour = -1;
    int index_in_pattern = 0;
    int pattern = -1;  // owning AlternatingMonoPattern
};

struct AlternatingMonoPattern {
    std::vector<int> streaks;
    int index_in_repeating = 0;
    int repeating = -1;  // owning RepeatingHitPatterns
    int mono_length(const std::vector<MonoStreak>& s) const {
        return s[streaks[0]].length;
    }
};

struct RepeatingHitPatterns {
    std::vector<int> patterns;
    int repetition_interval = kMaxRepetitionInterval + 1;
};

inline double sigmoid(double val, double center, double width, double middle, double height) {
    double s = std::tanh(M_E * -(val - center) / width);
    return s * (height / 2.0) + middle;
}

struct ColourEncoding {
    std::vector<MonoStreak> streaks;
    std::vector<AlternatingMonoPattern> patterns;
    std::vector<RepeatingHitPatterns> repeatings;
    // per note: which structure the note HEADS (or -1)
    std::vector<int> head_streak, head_pattern, head_repeating;

    void build(const std::vector<Note>& notes) {
        size_t n = notes.size();
        head_streak.assign(n, -1);
        head_pattern.assign(n, -1);
        head_repeating.assign(n, -1);

        // 1. mono streaks: maximal runs of same-colour hits (non-hits break)
        for (size_t i = 0; i < n; ++i) {
            if (!notes[i].is_hit()) continue;
            if (streaks.empty() || streaks.back().colour != notes[i].colour ||
                (i > 0 && !notes[i - 1].is_hit())) {
                streaks.push_back({static_cast<int>(i), 1, notes[i].colour, 0, -1});
            } else {
                streaks.back().length += 1;
            }
        }
        // fix runs interrupted by non-hits: the loop above only breaks on a
        // non-hit immediately before; also break when the previous streak's
        // notes are not contiguous with this hit
        // (handled by construction: the i-1 check covers it)

        // 2. alternating mono patterns: consecutive streaks of equal length
        for (size_t s = 0; s < streaks.size(); ++s) {
            bool fresh = patterns.empty();
            if (!fresh) {
                auto& cur = patterns.back();
                const auto& prev_streak = streaks[cur.streaks.back()];
                // streaks must be consecutive notes (no non-hit gap) and equal length
                bool contiguous = prev_streak.first + prev_streak.length == streaks[s].first;
                fresh = !contiguous || cur.mono_length(streaks) != streaks[s].length;
            }
            if (fresh) patterns.push_back({});
            streaks[s].pattern = static_cast<int>(patterns.size()) - 1;
            streaks[s].index_in_pattern = static_cast<int>(patterns.back().streaks.size());
            patterns.back().streaks.push_back(static_cast<int>(s));
        }

        // 3. repeating hit patterns: grouped by back-and-forth repetition
        //    (pattern i continues the group when it repeats pattern i-2)
        for (size_t p = 0; p < patterns.size(); ++p) {
            bool fresh = repeatings.empty();
            if (!fresh) {
                const auto& group = repeatings.back();
                size_t k = group.patterns.size();
                fresh = !(k >= 2 &&
                          patterns[p].mono_length(streaks) ==
                              patterns[group.patterns[k - 2]].mono_length(streaks));
                if (k == 1) {
                    // a second pattern always joins the group (it forms the
                    // "back" of the back-and-forth)
                    fresh = false;
                }
            }
            if (fresh) repeatings.push_back({});
            patterns[p].repeating = static_cast<int>(repeatings.size()) - 1;
            patterns[p].index_in_repeating =
                static_cast<int>(repeatings.back().patterns.size());
            repeatings.back().patterns.push_back(static_cast<int>(p));
        }

        // 4. repetition intervals between identical repeating groups
        for (size_t r = 0; r < repeatings.size(); ++r) {
            repeatings[r].repetition_interval = kMaxRepetitionInterval + 1;
            int interval = 1;
            for (int other = static_cast<int>(r) - 1;
                 other >= 0 && interval < kMaxRepetitionInterval; --other, ++interval) {
                if (is_repetition(r, other)) {
                    repeatings[r].repetition_interval = std::max(1, interval);
                    break;
                }
            }
        }

        // 5. note -> headed structure maps
        for (const auto& s : streaks) head_streak[s.first] = int(&s - &streaks[0]);
        for (size_t p = 0; p < patterns.size(); ++p) {
            int fs = patterns[p].streaks[0];
            head_pattern[streaks[fs].first] = static_cast<int>(p);
        }
        for (size_t r = 0; r < repeatings.size(); ++r) {
            int fp = repeatings[r].patterns[0];
            int fs = patterns[fp].streaks[0];
            head_repeating[streaks[fs].first] = static_cast<int>(r);
        }
    }

    bool is_repetition(size_t r, int other) const {
        const auto& a = repeatings[r];
        const auto& b = repeatings[other];
        if (a.patterns.size() != b.patterns.size()) return false;
        size_t check = std::min<size_t>(a.patterns.size(), 2);
        for (size_t i = 0; i < check; ++i) {
            if (patterns[a.patterns[i]].mono_length(streaks) !=
                patterns[b.patterns[i]].mono_length(streaks))
                return false;
        }
        return true;
    }

    double evaluate(int note_index) const {
        double difficulty = 0.0;
        int s = head_streak[note_index];
        if (s >= 0) {
            const auto& streak = streaks[s];
            const auto& pattern = patterns[streak.pattern];
            const auto& group = repeatings[pattern.repeating];
            double pattern_diff = sigmoid(pattern.index_in_repeating, 2, 2, 0.5, 1) *
                                  2.0 * (1.0 - sigmoid(group.repetition_interval, 2, 2, 0.5, 1));
            difficulty += sigmoid(streak.index_in_pattern, 2, 2, 0.5, 1) * pattern_diff * 0.5;
            if (head_pattern[note_index] >= 0) difficulty += pattern_diff;
            if (head_repeating[note_index] >= 0)
                difficulty += 2.0 * (1.0 - sigmoid(group.repetition_interval, 2, 2, 0.5, 1));
        }
        return difficulty;
    }
};

// rhythm-change ratio table (TaikoDifficultyHitObjectRhythm)
struct RhythmRatio {
    double ratio, difficulty;
};
const RhythmRatio kCommonRhythms[] = {
    {1.0 / 1.0, 0.0}, {2.0 / 1.0, 0.3}, {1.0 / 2.0, 0.5},
    {3.0 / 1.0, 0.3}, {1.0 / 3.0, 0.35}, {3.0 / 2.0, 0.6},
    {2.0 / 3.0, 0.4}, {5.0 / 4.0, 0.5}, {4.0 / 5.0, 0.7},
};

int closest_rhythm(double delta, double prev_delta) {
    double ratio = delta / prev_delta;
    int best = 0;
    double best_err = 1e18;
    for (int i = 0; i < 9; ++i) {
        double err = std::abs(kCommonRhythms[i].ratio - ratio);
        if (err < best_err) {
            best_err = err;
            best = i;
        }
    }
    return best;
}

double taiko_stars(const std::vector<Note>& notes) {
    using modern_common::SectionPeaks;
    using modern_common::norm;
    using modern_common::weighted_sum;

    size_t n = notes.size();
    if (n < 3) return 0.0;

    ColourEncoding colours;
    colours.build(notes);

    // per-note rhythm table (index into kCommonRhythms) and mono history
    std::vector<int> rhythm(n, 0);
    for (size_t i = 2; i < n; ++i) {
        double delta = notes[i].time - notes[i - 1].time;
        double prev_delta = notes[i - 1].time - notes[i - 2].time;
        rhythm[i] = prev_delta > 0 ? closest_rhythm(delta, prev_delta) : 0;
    }
    // previous same-colour indices (mono history) for the stamina evaluator
    std::vector<int> prev_mono1(n, -1);  // two same-colour hits back
    {
        std::vector<int> history[2];
        for (size_t i = 0; i < n; ++i) {
            if (!notes[i].is_hit()) continue;
            auto& h = history[notes[i].colour];
            if (h.size() >= 2) prev_mono1[i] = h[h.size() - 2];
            h.push_back(static_cast<int>(i));
        }
    }

    // --- the three skills, processed over objects from index 2 on
    // Colour: StrainDecaySkill(mult 0.12, decay 0.8)
    // Stamina: StrainDecaySkill(mult 1.1, decay 0.4)
    // Rhythm: StrainDecaySkill(mult 10, decay 0) with an internal 0.96 strain
    SectionPeaks colour_peaks, stamina_peaks, rhythm_peaks;
    double colour_strain = 0.0, stamina_strain = 0.0;
    double rhythm_internal = 0.0;
    int notes_since_rhythm_change = 0;
    std::vector<int> rhythm_history;  // last 8 note indices with rhythm data
    double prev_time = notes[1].time;

    auto repetition_penalties = [&](size_t i) {
        double penalty = 1.0;
        rhythm_history.push_back(static_cast<int>(i));
        if (rhythm_history.size() > 8) rhythm_history.erase(rhythm_history.begin());
        int count = static_cast<int>(rhythm_history.size());
        for (int most_recent = 2; most_recent <= 4; ++most_recent) {
            for (int start = count - most_recent - 1; start >= 0; --start) {
                bool same = true;
                for (int j = 0; j < most_recent; ++j) {
                    if (start + j >= count) { same = false; break; }
                    if (rhythm[rhythm_history[start + j]] !=
                        rhythm[rhythm_history[count - most_recent + j]]) {
                        same = false;
                        break;
                    }
                }
                if (!same) continue;
                int notes_since = static_cast<int>(i) - rhythm_history[start];
                penalty *= std::min(1.0, 0.032 * notes_since);
                break;
            }
        }
        return penalty;
    };

    for (size_t i = 2; i < n; ++i) {
        double time = notes[i].time;
        double delta = time - notes[i - 1].time;

        // colour
        double colour_value = notes[i].is_hit() ? colours.evaluate(static_cast<int>(i)) : 0.0;
        double colour_after = colour_strain * std::pow(0.8, delta / 1000.0) + colour_value * 0.12;
        colour_peaks.step(time, prev_time, colour_after, colour_strain, 0.8);
        colour_strain = colour_after;

        // stamina
        double stamina_value = 0.0;
        if (notes[i].is_hit() && prev_mono1[i] >= 0) {
            double interval = std::max(time - notes[prev_mono1[i]].time, 50.0);
            stamina_value = 0.5 + 30.0 / interval;
        }
        double stamina_after = stamina_strain * std::pow(0.4, delta / 1000.0) + stamina_value * 1.1;
        stamina_peaks.step(time, prev_time, stamina_after, stamina_strain, 0.4);
        stamina_strain = stamina_after;

        // rhythm (decay base 0: the skill strain IS the object value * 10)
        double rhythm_value = 0.0;
        if (!notes[i].is_hit()) {
            rhythm_internal = 0.0;
            notes_since_rhythm_change = 0;
        } else {
            rhythm_internal *= 0.96;
            notes_since_rhythm_change += 1;
            double base = kCommonRhythms[rhythm[i]].difficulty;
            if (base != 0.0) {
                double speed_penalty;
                if (delta < 80) {
                    speed_penalty = 1.0;
                } else if (delta < 210) {
                    speed_penalty = std::max(0.0, 1.4 - 0.005 * delta);
                } else {
                    rhythm_internal = 0.0;
                    notes_since_rhythm_change = 0;
                    speed_penalty = 0.0;
                }
                if (speed_penalty > 0.0) {
                    double object_strain = base;
                    object_strain *= repetition_penalties(i);
                    int len = notes_since_rhythm_change;
                    object_strain *= std::min(std::min(0.15 * len, 1.0),
                                              std::clamp(2.5 - 0.15 * len, 0.0, 1.0));
                    object_strain *= speed_penalty;
                    notes_since_rhythm_change = 0;
                    rhythm_internal += object_strain;
                    rhythm_value = rhythm_internal;
                }
            }
        }
        rhythm_peaks.step(time, prev_time, rhythm_value * 10.0, 0.0, 0.0);

        prev_time = time;
    }

    // Peaks combination (final_multiplier 0.0625)
    auto cp = colour_peaks.collect();
    auto rp = rhythm_peaks.collect();
    auto sp = stamina_peaks.collect();
    size_t sections = std::max({cp.size(), rp.size(), sp.size()});
    cp.resize(sections, 0.0);
    rp.resize(sections, 0.0);
    sp.resize(sections, 0.0);
    std::vector<double> peaks;
    for (size_t i = 0; i < sections; ++i) {
        double colour = cp[i] * 0.375 * 0.0625;
        double rhythm_peak = rp[i] * 0.2 * 0.0625;
        double stamina = sp[i] * 0.375 * 0.0625;
        double peak = norm(2.0, norm(1.5, colour, stamina), rhythm_peak);
        if (peak > 0) peaks.push_back(peak);
    }
    double combined = weighted_sum(peaks, 0.9) * 1.35;
    double sr = combined * 1.4;
    if (sr <= 0) return 0.0;
    return 10.43 * std::log(sr / 8.0 + 1.0);
}

}  // namespace modern_taiko

// ---------------------------------------------------------------------------
// catch (Movement skill + hyper-dash pre-pass)
// ---------------------------------------------------------------------------

namespace modern_catch {

constexpr double kNormalizedRadius = 41.0;
constexpr double kPositioningError = 16.0;
constexpr double kDirectionChangeBonus = 21.0;

double catch_stars(const std::vector<double>& times, const std::vector<double>& xs,
                   double cs) {
    using modern_common::SectionPeaks;
    using modern_common::weighted_sum;

    size_t n = times.size();
    if (n < 2) return 0.0;

    // catcher geometry (legacy scale-from-circle-size has a /2;
    // Catcher.CalculateCatchWidth applies ALLOWED_CATCH_RANGE 0.8)
    double scale = (1.0 - 0.7 * (cs - 5.0) / 5.0) / 2.0;
    double catch_width = 106.75 * std::abs(scale) * 0.8;
    double half_catcher = catch_width / 2.0;

    // hyper-dash pre-pass (CatchBeatmapProcessor.initialiseHyperDash) uses
    // the catcher half-width WITHOUT the allowed-catch-range reduction;
    // dash speed is 1 osu!px per ms
    double hyper_half_catcher = half_catcher / 0.8;
    std::vector<double> dist_to_hyper(n, 1e9);
    std::vector<bool> hyper(n, false);
    {
        double last_excess = hyper_half_catcher;
        int last_direction = 0;
        for (size_t i = 0; i + 1 < n; ++i) {
            int this_direction = xs[i + 1] > xs[i] ? 1 : -1;
            double time_to_next = times[i + 1] - times[i] - 1000.0 / 60.0 / 4.0;
            double dist_to_next =
                std::abs(xs[i + 1] - xs[i]) -
                (last_direction == this_direction ? last_excess : hyper_half_catcher);
            double d = time_to_next - dist_to_next;
            if (d < 0) {
                hyper[i] = true;
                dist_to_hyper[i] = 0.0;
                last_excess = hyper_half_catcher;
            } else {
                dist_to_hyper[i] = d;
                last_excess = std::clamp(d, 0.0, hyper_half_catcher);
            }
            last_direction = this_direction;
        }
    }

    // circle sizes above 5.5 reduce the catcher width further to simulate
    // imperfect gameplay (CatchDifficultyCalculator)
    double diff_half_catcher = half_catcher * (1.0 - 0.0625 * std::max(0.0, cs - 5.5));
    double scaling = kNormalizedRadius / diff_half_catcher;

    SectionPeaks peaks(750.0);
    double strain = 0.0;
    double player_position = xs[0] * scaling;
    double last_distance_moved = 0.0;
    double last_strain_time = 0.0;
    double prev_time = times[0];

    for (size_t i = 1; i < n; ++i) {
        double strain_time = std::max(40.0, times[i] - times[i - 1]);
        double normalized = xs[i] * scaling;

        double target = std::clamp(player_position,
                                   normalized - (kNormalizedRadius - kPositioningError),
                                   normalized + (kNormalizedRadius - kPositioningError));
        double distance_moved = target - player_position;
        double weighted_time = strain_time + 13.0 + 3.0;  // catcher speed 1
        double addition = std::pow(std::abs(distance_moved), 1.3) / 510.0;
        double sqrt_strain = std::sqrt(weighted_time);

        if (std::abs(distance_moved) > 0.1) {
            if (std::abs(last_distance_moved) > 0.1 &&
                ((distance_moved > 0) != (last_distance_moved > 0))) {
                double bonus_factor = std::min(50.0, std::abs(distance_moved)) / 50.0;
                double antiflow = std::max(std::min(70.0, std::abs(last_distance_moved)) / 70.0, 0.38);
                addition += kDirectionChangeBonus / std::sqrt(last_strain_time + 16.0) *
                            bonus_factor * antiflow *
                            std::max(1.0 - std::pow(weighted_time / 1000.0, 3.0), 0.0);
            }
            addition += 12.5 * std::min(std::abs(distance_moved), kNormalizedRadius * 2.0) /
                        (kNormalizedRadius * 6.0) / sqrt_strain;
        }

        double edge_dash_bonus = 0.0;
        if (dist_to_hyper[i - 1] <= 20.0) {
            if (!hyper[i - 1])
                edge_dash_bonus += 5.7;
            else
                target = normalized;
            addition *= 1.0 + edge_dash_bonus * ((20.0 - dist_to_hyper[i - 1]) / 20.0) *
                        std::pow(std::min(strain_time, 265.0) / 265.0, 1.5);
        }

        player_position = target;
        last_distance_moved = distance_moved;
        last_strain_time = strain_time;

        double value = addition / weighted_time;
        double delta = times[i] - times[i - 1];
        double after = strain * std::pow(0.2, delta / 1000.0) + value * 900.0;
        peaks.step(times[i], prev_time, after, strain, 0.2);
        strain = after;
        prev_time = times[i];
    }

    return std::sqrt(weighted_sum(peaks.collect(), 0.94)) * 0.153;
}

}  // namespace modern_catch

// ---------------------------------------------------------------------------
// mania (per-column + overall Strain)
// ---------------------------------------------------------------------------

namespace modern_mania {

double mania_stars(const std::vector<double>& starts, const std::vector<double>& ends,
                   const std::vector<int>& columns, int key_count) {
    using modern_common::SectionPeaks;
    using modern_common::weighted_sum;

    size_t n = starts.size();
    if (n < 2 || key_count < 1) return 0.0;

    constexpr double individual_decay = 0.125;
    constexpr double overall_decay = 0.30;
    constexpr double release_threshold = 24.0;

    auto decay = [](double v, double ms, double base) {
        return v * std::pow(base, ms / 1000.0);
    };
    auto definitely_bigger = [](double a, double b) { return a > b + 1.0; };

    std::vector<double> col_start(key_count, 0.0), col_end(key_count, 0.0);
    std::vector<double> col_strain(key_count, 0.0);
    double individual = 0.0, overall = 1.0;
    double prev_components[2] = {0.0, 1.0};

    SectionPeaks peaks;
    double prev_time = starts[0];

    for (size_t i = 1; i < n; ++i) {
        double start = starts[i], end = ends[i];
        int column = std::clamp(columns[i], 0, key_count - 1);
        double delta = start - starts[i - 1];

        bool overlapping = false;
        double closest_end = std::abs(end - start);
        double hold_factor = 1.0, hold_addition = 0.0;
        for (int c = 0; c < key_count; ++c) {
            overlapping |= definitely_bigger(col_end[c], start) && definitely_bigger(end, col_end[c]);
            if (definitely_bigger(col_end[c], end)) hold_factor = 1.25;
            closest_end = std::min(closest_end, std::abs(end - col_end[c]));
        }
        if (overlapping)
            hold_addition = 1.0 / (1.0 + std::exp(0.5 * (release_threshold - closest_end)));

        col_strain[column] = decay(col_strain[column], start - col_start[column], individual_decay);
        col_strain[column] += 2.0 * hold_factor;
        individual = delta <= 1.0 ? std::max(individual, col_strain[column]) : col_strain[column];
        overall = decay(overall, delta, overall_decay) + (1.0 + hold_addition) * hold_factor;

        col_start[column] = start;
        col_end[column] = end;

        double after = individual + overall;
        // boundary carry: each component decays with its own base
        // (lazer mania Strain.CalculateInitialStrain); capture the PREVIOUS
        // object's component values for sections opening before this object
        double prev_individual = prev_components[0], prev_overall = prev_components[1];
        peaks.step_with(start, prev_time, after, [&](double gap) {
            return decay(prev_individual, gap, individual_decay) +
                   decay(prev_overall, gap, overall_decay);
        });
        prev_components[0] = individual;
        prev_components[1] = overall;
        prev_time = start;
    }

    return weighted_sum(peaks.collect(), 0.9) * 0.018;
}

}  // namespace modern_mania

extern "C" {

double taiko_stars_v2(const double* times, const int32_t* colors, int32_t n, double clock_rate) {
    std::vector<modern_taiko::Note> notes(n);
    for (int32_t i = 0; i < n; ++i) notes[i] = {times[i] / clock_rate, colors[i]};
    return modern_taiko::taiko_stars(notes);
}

double catch_stars_v2(const double* times, const double* xs, int32_t n, double cs, double clock_rate) {
    std::vector<double> t(n), x(n);
    for (int32_t i = 0; i < n; ++i) {
        t[i] = times[i] / clock_rate;
        x[i] = xs[i];
    }
    return modern_catch::catch_stars(t, x, cs);
}

double mania_stars_v2(const double* starts, const double* ends, const int32_t* columns,
                      int32_t n, int32_t key_count, double clock_rate) {
    std::vector<double> s(n), e(n);
    std::vector<int> c(n);
    for (int32_t i = 0; i < n; ++i) {
        s[i] = starts[i] / clock_rate;
        e[i] = ends[i] / clock_rate;
        c[i] = columns[i];
    }
    return modern_mania::mania_stars(s, e, c, key_count);
}

}  // extern "C"
